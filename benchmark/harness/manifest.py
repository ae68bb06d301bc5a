"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a metric names a reader.
Each lives in a file of its own under this folder, so a new cell, mix,
configuration or metric is a new file and a new entry, never an edit:

- ``configs/<config>.json``: the file that ``BENCHMARK.json`` gives the
  configuration (a scene deployment: scene file, published camera, and
  ``reference``, the module ``reference/<reference>.py`` whose
  ``render_tiles`` renders it plainly);
- ``traffic/<traffic>.json``: a render job mix (resolution, spp, pass
  size, integrator settings, the seeded camera move, the check's tiles);
- ``metrics/<metric>.py``: a reader with ``compute(records)``;
- ``limits/<cell>.json``: the cell's check limits and their readings.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_DIR = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT_DIR, "BENCHMARK.json")


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_manifest(path: str = MANIFEST) -> dict:
    return _read_json(path)


def _by_name(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: str = ROOT_DIR) -> dict:
    """The configuration's file, its scene's ``path`` resolved from the
    folder the file lies in."""
    entry = _by_name(manifest["configs"], name, "configuration")
    path = os.path.join(root, entry["file"])
    cfg = _read_json(path)
    cfg["scene"]["path"] = os.path.join(os.path.dirname(path),
                                        cfg["scene"]["file"])
    return cfg


def reference(cfg: dict):
    """The configuration's plain reference, ``reference/<name>.py``."""
    import importlib

    return importlib.import_module("reference." + cfg["reference"])


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _read_json(os.path.join(bench_dir, "traffic", name + ".json"))


def limits(cell_name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _read_json(os.path.join(bench_dir, "limits", cell_name + ".json"))


def metrics_for(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: the end-to-end ones
    without a trace, the per-layer ones with it; an entry with a
    ``workloads`` key only in the cells it lists."""
    entries = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]


def load_metric(name: str, bench_dir: str = BENCH_DIR):
    """The reader module ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
