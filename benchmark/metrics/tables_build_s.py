"""Seconds the set-up spent building and uploading the scene's
intersection tables: the program's counter ``integrator.TABLES_S``, the
time of ``TracedScene.create`` (the binary BVH, the triangles' reorder,
the BVH32 collapse, and packing and uploading every table, K1's and
K2's among them), to the device's sync, read once the program is built.
A part of ``setup_s``. None for a program without the counter."""

NAME = "tables_build_s"


def attach(program, tracer):
    try:
        from pathtracer_tpu_torch import integrator
    except ImportError:
        return
    seconds = getattr(integrator, "TABLES_S", None)
    if isinstance(seconds, float) and seconds > 0.0:
        tracer.extra[NAME] = seconds


def compute(rec):
    tr = rec.get("trace")
    return tr["extra"].get(NAME) if tr else None
