#!/usr/bin/env python3
"""Build the gather probes (csrc/gather_probe.cu) with other tuning
constants and time the kernels each build changes on one CUDA card (an
H100).

    python3 probe_variants.py [--out FILE] [--sass FILE]

The source takes the threads a block of P1 (``gather_rows``), P3
(``gather_cols``), P4 (``gather_rows_warp``) and P5 (``stack_push_read``)
from the macros P1_THREADS, P3_THREADS, P4_THREADS and P5_THREADS, and
P4's rows a warp from P4_ROWS. Every entry of VARIANTS is compiled at once
(one nvcc each; the kernels' registers, static shared memory and spills
from ptxas go into the result), and the kernels it names are run at the
probe's shapes (N = 8,192 lanes of an (M, W) = (65,536, 8) table or its
transpose; a stack D = 64 deep) and at one lane (the kernel's launch
floor), held ``torch.equal`` against the plain versions, and timed on the
device (torch.profiler, 30 calls), in two passes over the variants so
that drift of the card shows. The default build times all four. With
``--sass``, FILE receives the default build's SASS (``cuobjdump -sass``,
where the toolkit has it). The card's name and power limit come first, as
nvidia-smi gives them; the last line is one JSON object of all the times.
Without a CUDA card it exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# name: (-D macros, the probes it times); the first is the source's default
VARIANTS = {
    "default": ((), ("P1", "P3", "P4", "P5")),
    "P1_THREADS=32": (("P1_THREADS=32",), ("P1",)),
    "P1_THREADS=64": (("P1_THREADS=64",), ("P1",)),
    "P4_THREADS=32": (("P4_THREADS=32",), ("P4",)),
    "P4_THREADS=64": (("P4_THREADS=64",), ("P4",)),
    "P4_ROWS=8": (("P4_ROWS=8",), ("P4",)),
    "P4_ROWS=32": (("P4_ROWS=32",), ("P4",)),
    "P3_THREADS=128": (("P3_THREADS=128",), ("P3",)),
    "P5_THREADS=128": (("P5_THREADS=128",), ("P5",)),
}
# each probe's kernels in the library (substrings of their names)
KERNELS = {"P1": "gather_rows", "P3": "gather_cols", "P4": "gather_rows_warp",
           "P5": "stack_push_read"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="a JSON file for the result")
    ap.add_argument("--sass", help="a file for the default build's SASS")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from k1_variants import sass
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.probes import gather as pg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda v: _build.build_cuda(
            pg.SOURCE, defines=v[0]), VARIANTS.values())))
    ptxas = {v: _build.ptxas_report(lib) for v, lib in libs.items()}
    sass_text = sass(libs["default"])
    if args.sass and sass_text is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.sass)),
                    exist_ok=True)
        with open(args.sass, "w") as fh:
            fh.write(sass_text)

    dev = torch.device("cuda", 0)
    x = pg.probe_inputs(dev)
    one = cs.one_lane(x)
    cases = {pid: (x, one) for pid in KERNELS}
    want = {pid: (pg.PLAIN[pid](x), pg.PLAIN[pid](one)) for pid in KERNELS}
    times = {v: {f"{pid}{label}": [] for pid in pids
                 for label in ("", " one lane")}
             for v, (_, pids) in VARIANTS.items()}
    for _ in range(2):
        for v, (defines, pids) in VARIANTS.items():
            pg._fns = _build.load_cuda(pg.SOURCE, pg.SIGNATURES, defines)
            for pid in pids:
                for inputs, expect, label in zip(cases[pid], want[pid],
                                                 ("", " one lane")):
                    got = pg.PROBES[pid](inputs)
                    torch.cuda.synchronize()
                    if not torch.equal(got, expect):
                        raise AssertionError(
                            f"variant {v} differs on {pid}{label}")
                    times[v][f"{pid}{label}"].append(cs.kernel_device_ms(
                        lambda: pg.PROBES[pid](inputs), KERNELS[pid]))
    pg._fns = None
    out = dict(card=smi, N=pg.N, M=pg.M, W=pg.W, D=pg.D, variants=VARIANTS,
               ptxas=ptxas, sass=sass_text is not None, device_ms=times)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
