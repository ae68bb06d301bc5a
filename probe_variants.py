#!/usr/bin/env python3
"""Build the gather probes (csrc/gather_probe.cu) with other tuning
constants and time P3 (``gather_cols``) and P5 (``stack_push_read``) of
each build on one CUDA card (an H100).

    python3 probe_variants.py [--out FILE]

The source takes the threads a block of the two kernels from the macros
P3_THREADS and P5_THREADS. Every entry of VARIANTS is compiled at once
(one nvcc each; the two kernels' registers, static shared memory and
spills from ptxas go into the result), run at the probe's shapes (N =
8,192 lanes of a (W, M) = (8, 65,536) table; a stack D = 64 deep) and at
one lane (the kernel's launch floor), held ``torch.equal`` against the
plain versions, and timed on the device (torch.profiler, 30 calls), in
two passes over the variants so that drift of the card shows. The card's
name and power limit come first, as nvidia-smi gives them; the last line
is one JSON object of all the times. Without a CUDA card it exits
non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# name: -D macros; the first is the source's default
VARIANTS = {
    "default": (),
    "P3_THREADS=32": ("P3_THREADS=32",),
    "P3_THREADS=128": ("P3_THREADS=128",),
    "P3_THREADS=256": ("P3_THREADS=256",),
    "P5_THREADS=32": ("P5_THREADS=32",),
    "P5_THREADS=128": ("P5_THREADS=128",),
}
# the two kernels' names in the library (substrings of the mangled names)
KERNELS = {"P3": "gather_cols", "P5": "stack_push_read"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="a JSON file for the result")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.probes import gather as pg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda d: _build.build_cuda(
            pg.SOURCE, defines=d), VARIANTS.values())))
    ptxas = {v: {name: report for name, report in
                 _build.ptxas_report(lib).items()
                 if any(kernel in name for kernel in KERNELS.values())}
             for v, lib in libs.items()}

    dev = torch.device("cuda", 0)
    x = pg.probe_inputs(dev)
    one = cs.one_lane(x)
    cases = {"P3": ("P3", x), "P5": ("P5", x), "P3 one lane": ("P3", one),
             "P5 one lane": ("P5", one)}
    want = {case: pg.PLAIN[pid](inputs) for case, (pid, inputs)
            in cases.items()}
    times = {v: {case: [] for case in cases} for v in VARIANTS}
    for _ in range(2):
        for v, defines in VARIANTS.items():
            pg._fns = _build.load_cuda(pg.SOURCE, pg.SIGNATURES, defines)
            for case, (pid, inputs) in cases.items():
                got = pg.PROBES[pid](inputs)
                torch.cuda.synchronize()
                if not torch.equal(got, want[case]):
                    raise AssertionError(f"variant {v} differs on {case}")
                times[v][case].append(cs.kernel_device_ms(
                    lambda: pg.PROBES[pid](inputs), KERNELS[pid]))
    pg._fns = None
    out = dict(card=smi, N=pg.N, M=pg.M, W=pg.W, D=pg.D, variants=VARIANTS,
               ptxas=ptxas, device_ms=times)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
