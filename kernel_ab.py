#!/usr/bin/env python3
"""Time every kernel wrapper of two checkouts of the port, in turns, on one
CUDA card (an H100).

    python3 kernel_ab.py --parent DIR [--out FILE]

DIR is another checkout of the repository, such as the parent commit
unpacked with ``git archive`` into a gitignored directory. The script runs
one process per turn, in the order parent, change, change, parent (the
change is this script's own checkout). Each process imports the package
from its checkout, builds its kernels, and measures every wrapper at
``chip_smoke.py``'s shapes: K1 (131,072 cornell camera and shadow rays x
36 triangles, closest and any hit; the render set, the 130,732 lanes of
bounce 2 of the last band of a 640x480 cornell render, with the
integrator's t_max, 0 on the lanes not active, and with t_max inf on every
lane), K2 (131,072 rays on the 4,000-box field: closest and any hit, on
the camera and room rays and on the bounce rays) and the probes P1-P9,
P1-P5 also at one lane and P6-P9 at one index row (their launch
floors):

  host_us    host time per call over 10,000 calls (``chip_smoke.host_us``)
  ms         per call over 100 back-to-back calls on CUDA events (the
             median of 5 such runs)
  ms_single  median of 30 single calls on CUDA events
  device_ms  device time per call from torch.profiler (all of its kernels)

Then the cornell render of ``chip_smoke.py`` phase ``main`` (640x480,
16 spp, depth 5, onesample): Mrays/s of three timed renders after a
warm-up (median, min, max), and one more render under torch.profiler
(K1's device time and share of the render's).

Each turn prints one JSON line; the last line gathers them by kernel and
checkout. With ``--out``, FILE receives the same and each turn's whole
output (the compilers' reports among it) goes beside it as
``kernel_ab_turn<i>.log``. The card's name and power limit
come first, as nvidia-smi gives them. Without a CUDA card it exits
non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))


def measure(tree: str) -> dict:
    """Every wrapper's times, the package imported from ``tree``."""
    import chip_smoke as cs  # this checkout's timers, before ``tree``
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import pathtracer_tpu_torch
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.probes import gather as pg
    from pathtracer_tpu_torch.probes import gather2 as pg2

    pkg = os.path.dirname(os.path.abspath(pathtracer_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "pathtracer_tpu_torch"):
        raise AssertionError(f"imported {pkg}, not the package of {tree}")
    # each tree's own build and load (the launch path differs by tree)
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda m: m.build(verbose=True), (k1, k2, pg, pg2)))
    for mod in (k1, k2, pg, pg2):
        mod._load()
    dev = torch.device("cuda", 0)
    scene, o, d, t_max = cs.k1_inputs(dev)
    _, ro, rd, r_live, r_inf = cs.k1_render_inputs(dev)
    box, bo, bd, t_inf, t_any = cs.k2_inputs(dev)
    _, co, cd, t_live, t_live_any = cs.k2_bounce_inputs(dev)
    x1, x2 = pg.probe_inputs(dev), pg2.probe_inputs(dev)

    def k2_case(o, d, bound, any_hit=False):
        return lambda: k2.bvhw_intersect(box.bw_rows, o, d, bound,
                                         any_hit=any_hit,
                                         stackw=box.bw_depth)
    tri_pack = scene.tri_pack
    cases = {
        "K1": lambda: k1.intersect(o, d, t_max, tri_pack),
        "K1 any-hit": lambda: k1.intersect(o, d, t_max, tri_pack,
                                           any_hit=True),
        "K1 render": lambda: k1.intersect(ro, rd, r_live, tri_pack),
        "K1 render t_max inf": lambda: k1.intersect(ro, rd, r_inf, tri_pack),
        "K2": k2_case(bo, bd, t_inf),
        "K2 any-hit": k2_case(bo, bd, t_any, True),
        "K2 bounce": k2_case(co, cd, t_live),
        "K2 bounce any-hit": k2_case(co, cd, t_live_any, True)}
    for probes, x in ((pg.PROBES, x1), (pg2.PROBES, x2)):
        for pid, fn in probes.items():
            cases[pid] = lambda fn=fn, x=x: fn(x)
    one, one2 = cs.one_lane(x1), cs.one_row(x2)
    for pid, fn in pg.PROBES.items():
        cases[f"{pid} one lane"] = lambda fn=fn: fn(one)
    for pid, fn in pg2.PROBES.items():
        cases[f"{pid} one row"] = lambda fn=fn: fn(one2)
    out = {name: dict(host_us=cs.host_us(fn), ms=cs.per_call_ms(fn),
                      ms_single=cs.time_ms(fn))
           for name, fn in cases.items()}
    cornell = cornell_renders(dev, k1)
    # last: an active trace slows later launches
    for name, fn in cases.items():
        out[name]["device_ms"] = cs.kernel_device_ms(fn)
    cornell["profile"] = cs.cornell_render_profile(dev, spp=16)
    return dict(tree=os.path.abspath(tree), kernels=out, cornell=cornell)


def cornell_renders(dev, k1) -> dict:
    """Phase ``main``'s cornell render: a warm-up, then
    ``chip_smoke.timed_renders`` (exact K1 launch counts)."""
    import chip_smoke as cs
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(cs.CORNELL, resolution=(640, 480), device=dev)
    scene = TracedScene.create(sd)
    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    integ = PathIntegrator(cfg, spp=16)
    _, n_bands = integ.band_layout(cam)
    integ.render(cam, scene)  # warm-up
    _, runs = cs.timed_renders(
        integ, cam, scene, {k1: n_bands * integ.spp * (2 * cfg.max_depth + 1)},
        "cornell")
    return runs


def run_turns(script: str, parent: str, out: str | None,
              log_name: str) -> tuple[str, list]:
    """``script --measure TREE`` in one process a turn, in the order
    parent, change, change, parent (the change is this checkout), each
    turn's last line a JSON object, printed with its ``label``. With
    ``out``, each turn's whole output goes beside it as
    ``<log_name>_turn<i>.log``. Returns (the card's name and power limit
    as nvidia-smi gives them, printed first; the turns' objects)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = [("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)]
    out_dir = None
    if out:
        out_dir = os.path.dirname(os.path.abspath(out))
        os.makedirs(out_dir, exist_ok=True)
    runs = []
    for turn, (label, tree) in enumerate(turns):
        res = subprocess.run([sys.executable, os.path.abspath(script),
                              "--measure", tree], capture_output=True,
                             text=True, timeout=900)
        if out_dir:
            with open(os.path.join(out_dir, f"{log_name}_turn{turn}.log"),
                      "w") as fh:
                fh.write(res.stdout + res.stderr)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-8000:])
            raise RuntimeError(f"{label} turn failed ({res.returncode})")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["label"] = label
        runs.append(run)
        print(json.dumps(run), flush=True)
    return smi, runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout to time")
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
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi, runs = run_turns(__file__, args.parent, args.out, "kernel_ab")
    summary = dict(card=smi, order=[r["label"] for r in runs], kernels={
        name: {label: [r["kernels"][name] for r in runs
                       if r["label"] == label]
               for label in ("parent", "change")}
        for name in runs[0]["kernels"]}, cornell={
        label: [r["cornell"] for r in runs if r["label"] == label]
        for label in ("parent", "change")})
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
