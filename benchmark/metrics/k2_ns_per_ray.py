"""K2's device time per ray in the traced passes (ns): the summed device
time of the K2 kernels linked to their ``pt::k:bvhw`` span
(``harness/links.py``) over the lanes those launches covered, the
program's count ``ops/cuda/bvhw_cu.RAYS`` (every lane of a launch, live or
not; under graph replay the capture's tally a replay), read as the traced
passes begin and end. What a closest-hit or shadow query costs the card,
a ray at a time, on the cell's table. None for a program without the
count, or where no K2 kernel ran."""

from harness import links

NAME = "k2_ns_per_ray"


def attach(program, tracer):
    links.attach(tracer)
    try:
        from pathtracer_tpu_torch.ops.cuda import bvhw_cu
    except ImportError:
        return
    if not hasattr(bvhw_cu, "RAYS"):
        return
    mark = {}
    tracer.on_start.append(lambda: mark.update(start=bvhw_cu.RAYS))
    tracer.on_stop.append(
        lambda: tracer.extra.update({NAME: bvhw_cu.RAYS - mark["start"]}))


def compute(rec):
    got = links.found(rec)
    rays = rec["trace"]["extra"].get(NAME) if rec.get("trace") else None
    if got is None or not rays or got["k2_s"] <= 0:
        return None
    return got["k2_s"] * 1e9 / rays
