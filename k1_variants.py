#!/usr/bin/env python3
"""Build kernel K1 (csrc/intersect.cu) with other block sizes and time each
build on one CUDA card (an H100).

    python3 k1_variants.py [--out FILE] [--sass FILE]

The source takes its threads a block from the macro K1_BLOCK. Every size
of VARIANTS is compiled at once (one nvcc each; its registers and spills
from ptxas go into the result), run on
``chip_smoke.py``'s two K1 ray sets (131,072 cornell camera and shadow
rays, closest and any hit; the render set, the 130,732 lanes of bounce 2
of the last band of a 640x480 cornell render, with the integrator's t_max
and with t_max inf on every lane), held ``torch.equal`` against the
default build's results, and timed on the device (torch.profiler, 30
calls), in two passes over the variants so that drift of the card shows.
With ``--sass``, FILE receives the default build's SASS (``cuobjdump
-sass``, where the toolkit has it). The card's name and power limit come
first, as nvidia-smi gives them; the last line is one JSON object of all
the times. Without a CUDA card it exits non-zero.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# threads a block; the first is the source's default
VARIANTS = [512, 128, 256, 1024]


def defines(block: int) -> tuple:
    return (f"K1_BLOCK={block}",)


def sass(library: str) -> str:
    """``cuobjdump -sass`` of ``library``: the toolkit's, or the one
    Triton carries; None where neither is there."""
    from pathtracer_tpu_torch.ops.cuda import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        try:
            import triton
            tool = os.path.join(os.path.dirname(triton.__file__), "backends",
                                "nvidia", "bin", "cuobjdump")
        except ImportError:
            return None
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="a JSON file for the result")
    ap.add_argument("--sass", help="a file for the default build's SASS")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(lambda v: _build.build_cuda(
            k1.SOURCE, defines=defines(v)), VARIANTS))
    registers = {}
    for v, lib in zip(VARIANTS, libs):
        registers[str(v)] = {
            ("any_hit" if "ILb1E" in name else "closest"): regs
            for name, regs in _build.ptxas_report(lib).items()}
    sass_text = sass(k1.build())
    if args.sass and sass_text is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.sass)),
                    exist_ok=True)
        with open(args.sass, "w") as fh:
            fh.write(sass_text)

    dev = torch.device("cuda", 0)
    scene, o, d, t_max = cs.k1_inputs(dev)
    _, ro, rd, t_live, t_inf = cs.k1_render_inputs(dev)
    tri_pack = scene.tri_pack
    cases = {"K1": (o, d, t_max, False), "K1 any-hit": (o, d, t_max, True),
             "render": (ro, rd, t_live, False),
             "render t_max inf": (ro, rd, t_inf, False)}

    def run(case):
        co, cd, bound, any_hit = cases[case]
        return k1.intersect(co, cd, bound, tri_pack, any_hit=any_hit)

    k1._fns = None  # the default build
    want = {case: run(case) for case in cases}
    torch.cuda.synchronize()
    times = {str(v): {case: [] for case in cases}
             for v in VARIANTS}
    for _ in range(2):
        for v in VARIANTS:
            k1._fns = _build.load_cuda(k1.SOURCE, k1.SIGNATURES, defines(v))
            for case in cases:
                got = run(case)
                torch.cuda.synchronize()
                same = torch.equal(got, want[case]) if cases[case][3] else \
                    all(torch.equal(got[k], want[case][k]) for k in got)
                if not same:
                    raise AssertionError(f"variant {v} differs on {case}")
                times[str(v)][case].append(
                    cs.kernel_device_ms(lambda: run(case), "intersect_kernel"))
    k1._fns = None
    out = dict(card=smi, rays=int(o.shape[0]), render_rays=int(ro.shape[0]),
               render_live=int((t_live > 0).sum()),
               triangles=int(tri_pack.shape[0]), registers=registers,
               sass=sass_text is not None, device_ms=times)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
