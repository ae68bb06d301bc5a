#!/usr/bin/env python3
"""Build the gather probes (csrc/gather_probe.cu, csrc/gather_probe2.cu)
with other tuning constants and time the kernels each build changes on
one CUDA card (an H100).

    python3 probe_variants.py [--out FILE] [--sass FILE]

csrc/gather_probe.cu takes the threads a block of P1 (``gather_rows``),
P3 (``gather_cols``), P4 (``gather_rows_warp``) and P5
(``stack_push_read``) from the macros P1_THREADS, P3_THREADS, P4_THREADS
and P5_THREADS, and P4's rows a warp from P4_ROWS; csrc/gather_probe2.cu
takes P8's (``gather_two_step``) index rows a block, 128 threads each,
from P8_ROWS. Every entry of VARIANTS is compiled at once (one nvcc
each; the kernels' registers, static shared memory and spills from ptxas
go into the result), and the kernels it names are run at the probe's
shapes (P1-P5: N = 8,192 lanes of an (M, W) = (65,536, 8) table or its
transpose, a stack D = 64 deep; P8: S = 64 index rows of a (548, 128)
table) and at their smallest input (one lane; one index row: the
kernel's launch floor), held ``torch.equal`` against the plain versions
(P8 also at S = 3 and 65, a ragged last block), and timed on the device
(torch.profiler, 30 calls), in two passes over the variants so that
drift of the card shows. The default builds time P1, P3, P4, P5 and P8.
With ``--sass``, FILE receives both default builds' SASS (``cuobjdump
-sass``, where the toolkit has it: gather_rows ... stack_push_read, then
gather_two_step among P6-P9's kernels). The card's name and power limit
come first, as nvidia-smi gives them; the last line is one JSON object
of all the times. Without a CUDA card it exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# name: (source, -D macros, the probes it times); each source's first entry
# is its default build
VARIANTS = {
    "default": ("gather", (), ("P1", "P3", "P4", "P5")),
    "P1_THREADS=32": ("gather", ("P1_THREADS=32",), ("P1",)),
    "P1_THREADS=64": ("gather", ("P1_THREADS=64",), ("P1",)),
    "P4_THREADS=32": ("gather", ("P4_THREADS=32",), ("P4",)),
    "P4_THREADS=64": ("gather", ("P4_THREADS=64",), ("P4",)),
    "P4_ROWS=8": ("gather", ("P4_ROWS=8",), ("P4",)),
    "P4_ROWS=32": ("gather", ("P4_ROWS=32",), ("P4",)),
    "P3_THREADS=128": ("gather", ("P3_THREADS=128",), ("P3",)),
    "P5_THREADS=128": ("gather", ("P5_THREADS=128",), ("P5",)),
    "P8 default": ("gather2", (), ("P8",)),
    "P8_ROWS=2": ("gather2", ("P8_ROWS=2",), ("P8",)),
    "P8_ROWS=4": ("gather2", ("P8_ROWS=4",), ("P8",)),
}
# each probe's kernels in its library (substrings of their names)
KERNELS = {"P1": "gather_rows", "P3": "gather_cols", "P4": "gather_rows_warp",
           "P5": "stack_push_read", "P8": "gather_two_step"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="a JSON file for the result")
    ap.add_argument("--sass", help="a file for the default builds' SASS")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from k1_variants import sass
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.probes import gather, gather2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    mods = {"gather": gather, "gather2": gather2}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda v: _build.build_cuda(
            mods[v[0]].SOURCE, defines=v[1]), VARIANTS.values())))
    ptxas = {v: _build.ptxas_report(lib) for v, lib in libs.items()}
    sass_text = [sass(libs[v]) for v in ("default", "P8 default")]
    if args.sass and None not in sass_text:
        os.makedirs(os.path.dirname(os.path.abspath(args.sass)),
                    exist_ok=True)
        with open(args.sass, "w") as fh:
            fh.write("\n".join(sass_text))

    dev = torch.device("cuda", 0)
    x, x2 = gather.probe_inputs(dev), gather2.probe_inputs(dev)
    cases = {pid: (x, cs.one_lane(x), " one lane")
             for pid in ("P1", "P3", "P4", "P5")}
    cases["P8"] = (x2, cs.one_row(x2), " one row")
    plain = dict(gather.PLAIN, **gather2.PLAIN)
    want = {pid: (plain[pid](a), plain[pid](b))
            for pid, (a, b, _) in cases.items()}
    times = {v: {f"{pid}{label}": [] for pid in pids
                 for label in ("", cases[pid][2])}
             for v, (_, _, pids) in VARIANTS.items()}
    for _ in range(2):
        for v, (src, defines, pids) in VARIANTS.items():
            mod = mods[src]
            mod._fns = _build.load_cuda(mod.SOURCE, mod.SIGNATURES, defines)
            for rows in (3, 65) if "P8" in pids else ():
                xr = gather2.ragged_inputs(rows, dev)
                if not torch.equal(gather2.PROBES["P8"](xr),
                                   gather2.PLAIN["P8"](xr)):
                    raise AssertionError(f"variant {v} differs on P8 at "
                                         f"S = {rows}")
            for pid in pids:
                a, b, small = cases[pid]
                for inputs, expect, label in zip((a, b), want[pid],
                                                 ("", small)):
                    got = mod.PROBES[pid](inputs)
                    torch.cuda.synchronize()
                    if not torch.equal(got, expect):
                        raise AssertionError(
                            f"variant {v} differs on {pid}{label}")
                    times[v][f"{pid}{label}"].append(cs.kernel_device_ms(
                        lambda: mod.PROBES[pid](inputs), KERNELS[pid]))
    gather._fns = gather2._fns = None
    out = dict(card=smi, N=gather.N, M=gather.M, W=gather.W, D=gather.D,
               S=gather2.S, C=gather2.C, variants=VARIANTS, ptxas=ptxas,
               sass=None not in sass_text, device_ms=times)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
