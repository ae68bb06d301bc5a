#!/usr/bin/env python3
"""Build kernel K2 (csrc/bvhw.cu) with other tuning constants and time each
build on one CUDA card (an H100).

    python3 k2_variants.py [--out FILE]

The source takes its rays a warp, its warps a block and the blocks an SM
must hold (a cap on registers) from three macros (K2_RAYS_PER_WARP,
K2_WARPS_PER_BLOCK, K2_MIN_BLOCKS). Every triple of VARIANTS is compiled
at once (one nvcc each, its registers and spills printed), run on
``chip_smoke.py``'s two K2 ray sets on the 4,000-box field (131,072 camera
and room rays; 131,072 bounce rays with dead lanes), closest and any hit,
and on three sets that take the walk apart (the camera half and the room
half of the first set alone; one room ray repeated 131,072 times, so every
row read hits L1 and no two warps differ; every lane dead), held
``torch.equal`` against the default build's results, and timed on the
device (torch.profiler, 30 calls), in two passes over the variants so that
drift of the card shows. The rows each set visits (counted by the plain
traversal) go into the result, for a time per row. The card's name and
power limit come first, as nvidia-smi gives them; the last line is one
JSON object of all the times. Without a CUDA card it exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# (rays a warp, warps a block, blocks an SM must hold)
VARIANTS = [(4, 2, 20), (4, 2, 16), (4, 2, 24), (4, 4, 10), (4, 4, 8),
            (4, 4, 1), (4, 8, 5), (1, 2, 20), (2, 2, 20), (8, 2, 20),
            (16, 2, 20), (32, 2, 20)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="a JSON file for the result")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pathtracer_tpu_torch.accel.bvhw import bvhw_intersect as bvhw_plain
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def defines(variant):
        return (f"K2_RAYS_PER_WARP={variant[0]}",
                f"K2_WARPS_PER_BLOCK={variant[1]}",
                f"K2_MIN_BLOCKS={variant[2]}")

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        list(pool.map(lambda v: _build.build_cuda(
            k2.SOURCE, verbose=True, defines=defines(v)), VARIANTS))

    dev = torch.device("cuda", 0)
    scene, o, d, t_inf, t_any = cs.k2_inputs(dev)
    _, bo, bd, t_live, t_live_any = cs.k2_bounce_inputs(dev)
    table, stackw = scene.bw_rows, scene.bw_depth
    n, half = o.shape[0], o.shape[0] // 2
    one = half + 5  # a room ray that visits 13 rows
    cases = {"camera": (o, d, t_inf, False), "camera any-hit":
             (o, d, t_any, True), "bounce": (bo, bd, t_live, False),
             "bounce any-hit": (bo, bd, t_live_any, True),
             "camera half": (o[:half].contiguous(), d[:half].contiguous(),
                             t_inf[:half], False),
             "room half": (o[half:].contiguous(), d[half:].contiguous(),
                           t_inf[half:], False),
             "one ray": (o[one:one + 1].expand(n, 3).contiguous(),
                         d[one:one + 1].expand(n, 3).contiguous(), t_inf,
                         False),
             "all dead": (o, d, torch.zeros_like(t_inf), False)}
    rows = {}
    for case, (co, cd, bound, any_hit) in cases.items():
        rows[case] = {}
        few = 1 if case == "one ray" else co.shape[0]  # the same ray n times
        bvhw_plain(table, co[:few], cd[:few], bound[:few], any_hit=any_hit,
                   stackw=stackw, row_counts=rows[case])
        rows[case]["rays"] = few

    def run(case):
        co, cd, bound, any_hit = cases[case]
        return k2.bvhw_intersect(table, co, cd, bound, any_hit=any_hit,
                                 stackw=stackw)

    k2._fns = None  # the default build
    want = {case: run(case) for case in cases}
    torch.cuda.synchronize()
    times = {"x".join(map(str, v)): {case: [] for case in cases}
             for v in VARIANTS}
    for _ in range(2):
        for v in VARIANTS:
            k2._fns = _build.load_cuda(k2.SOURCE, k2.SIGNATURES, defines(v))
            for case in cases:
                got = run(case)
                torch.cuda.synchronize()
                same = torch.equal(got, want[case]) if cases[case][3] else \
                    all(torch.equal(got[k], want[case][k]) for k in got)
                if not same:
                    raise AssertionError(f"variant {v} differs on {case}")
                times["x".join(map(str, v))][case].append(cs.kernel_device_ms(
                    lambda: run(case), "bvhw_kernel"))
    k2._fns = None
    out = dict(card=smi, rays=int(o.shape[0]), rows_visited=rows,
               device_ms=times)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
