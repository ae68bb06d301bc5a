#!/usr/bin/env python3
"""Render classroom and Sponza with two checkouts of the port, in turns,
on one CUDA card (an H100).

    python3 render_ab.py --parent DIR [--out FILE]

DIR is another checkout of the repository, such as the parent commit
unpacked with ``git archive`` into a gitignored directory. The script runs
one process per turn, in the order parent, change, change, parent (the
change is this script's own checkout). Each process imports the package
from its checkout and renders ``chip_smoke.py``'s classroom and Sponza
main paths (1920x1080, 2 spp, depth 5, "onesample"): a warm-up, then
three timed renders (``chip_smoke.timed_renders``: Mrays/s median, min
and max, exact K2 counts, each render's retry counts and, where the
checkout has them, K3's and K4's launches), then one render under
torch.profiler (``chip_smoke.render_profile``): device time, device
events a band-frame, the device's busy share, K2's, K3's and K4's device
time and share, and the device time of the torch ops inside the
``texture_lookup`` (classroom) or ``alpha_cut`` (Sponza) ranges.

Each turn prints one JSON line (``kernel_ab.run_turns``); the last line
gathers them by scene and checkout. With ``--out``, FILE receives the
same and each turn's whole output goes beside it as
``render_ab_turn<i>.log``. The card's name and power limit come first,
as nvidia-smi gives them. Without a CUDA card it exits non-zero.
"""

import argparse
import json
import os
import sys

from kernel_ab import run_turns

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = {"classroom": ("classroom_proc.glb", "texture_lookup"),
          "sponza": ("sponza_proc.glb", "alpha_cut")}


def measure(tree: str) -> dict:
    """Both scenes' renders, the package imported from ``tree``."""
    import chip_smoke as cs  # this checkout's timers, before ``tree``
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import pathtracer_tpu_torch
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    pkg = os.path.dirname(os.path.abspath(pathtracer_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "pathtracer_tpu_torch"):
        raise AssertionError(f"imported {pkg}, not the package of {tree}")
    dev = torch.device("cuda", 0)
    out = {}
    for name, (glb, annotation) in SCENES.items():
        cam, scene, _, _ = cs.classroom_scene(
            dev, (1920, 1080), os.path.join(ROOT, "data", glb))
        cfg = PathConfig(max_depth=5, mis_mode="onesample")
        integ = PathIntegrator(cfg, spp=2)
        _, n_bands = integ.band_layout(cam)
        integ.render(cam, scene)  # warm-up (and the kernels' build)
        torch.cuda.synchronize()
        _, runs = cs.timed_renders(
            integ, cam, scene,
            {k2: n_bands * integ.spp * (2 * cfg.max_depth + 1), k1: 0}, name)
        prof = cs.render_profile(
            cam, scene, integ.spp, "bvhw_kernel", annotation=annotation,
            warmup=False, kernels=("texture_eval_kernel", "alpha_cut_kernel"))
        out[name] = dict(runs=runs, profile=prof)
    return dict(tree=os.path.abspath(tree), scenes=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout to render with")
    ap.add_argument("--out", help="a JSON file for the summary")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("render_ab: no CUDA device", file=sys.stderr)
        return 1
    smi, runs = run_turns(__file__, args.parent, args.out, "render_ab")
    summary = dict(card=smi, order=[r["label"] for r in runs], scenes={
        name: {label: [r["scenes"][name] for r in runs
                       if r["label"] == label]
               for label in ("parent", "change")}
        for name in SCENES})
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
