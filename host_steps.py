#!/usr/bin/env python3
"""Split the host cost of the P6 and P7 wrappers into their steps, on one
CUDA card (an H100).

    python3 host_steps.py [--tree DIR]

DIR is a checkout of the repository whose package is measured (default:
this script's own), such as a parent commit unpacked with ``git archive``
into a gitignored directory. For P6 (``gather_sublane``) and P7
(``gather_lane``) at the probe's shapes (64 index rows of 128 lanes) it
times each step of a wrapper call with a host clock over 10,000 calls
(``chip_smoke.host_us``), and the whole call beside them:

  loop          an empty call, the timing loop's own cost (not subtracted)
  args          the wrapper's argument check (``_lane_args``)
  empty         the output's allocation by ``torch.empty``
  empty_like    and by ``torch.empty_like`` (of idx, as float32, for P6;
                of data for P7)
  data_ptr      one ``data_ptr()`` (a call reads three)
  stream        ``torch._C._cuda_getDevice`` and
                ``torch._C._cuda_getCurrentRawStream``
  launcher      the call into the C launcher (the kernel launch included):
                a ctypes function, or the CPython trampoline with the
                launcher's address, whichever the checkout has
  count         the ``LAUNCHES`` update
  wrapper       the whole wrapper
  library       ``torch.gather`` on the same inputs

Then device times from torch.profiler: P6 and P7 at 64 rows, P7 at one
row (the card's floor for a kernel of this kind: one block of 128
threads) and ``torch.gather``'s. The card's name and power limit come
first, as nvidia-smi gives them; the last line is one JSON object. Without
a CUDA card it exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def measure(tree: str) -> dict:
    import chip_smoke as cs  # this checkout's timers, before ``tree``
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import pathtracer_tpu_torch
    from pathtracer_tpu_torch.probes import gather2 as pg

    pkg = os.path.dirname(os.path.abspath(pathtracer_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "pathtracer_tpu_torch"):
        raise AssertionError(f"imported {pkg}, not the package of {tree}")
    pg.build()
    fns = pg._load()
    dev = torch.device("cuda", 0)
    x = pg.probe_inputs(dev)
    steps = {}
    for pid, kernel, dim, data, idx, extra in (
            ("P6", "gather_sublane", 0, x["data_g"], x["idx_g"],
             (pg.S, pg.C)),
            ("P7", "gather_lane", 1, x["data_h"], x["idx_h"], (pg.S,))):
        wrapper = getattr(pg, kernel)
        out = wrapper(data, idx)
        ptrs = (data.data_ptr(), idx.data_ptr(), *extra, out.data_ptr())
        # keyed by kernel (this tree's launch path) or by C name (ctypes)
        fn = fns[kernel] if kernel in fns else fns[f"pt_{kernel}_launch"]
        stream = torch._C._cuda_getCurrentRawStream(0)
        if isinstance(fn, tuple):  # (trampoline, launcher address)
            def launcher(fn=fn, ptrs=ptrs):
                return fn[0](fn[1], *ptrs, stream)
        else:  # a ctypes function
            def launcher(fn=fn, ptrs=ptrs):
                return fn(*ptrs, stream)
        table_rows = pg.S if pid == "P7" else None

        def args(kernel=kernel, data=data, idx=idx, table_rows=table_rows):
            return pg._lane_args(kernel, data, idx, table_rows)

        def count(kernel=kernel):
            pg.LAUNCHES[kernel] += 1

        def stream_fn():
            torch._C._cuda_getDevice()
            return torch._C._cuda_getCurrentRawStream(0)
        cases = dict(
            loop=lambda: None, args=args,
            empty=lambda: torch.empty(pg.S, pg.L, dtype=torch.float32,
                                      device=dev),
            empty_like=(lambda i=idx: torch.empty_like(
                i, dtype=torch.float32)) if pid == "P6"
            else (lambda a=data: torch.empty_like(a)),
            data_ptr=data.data_ptr, stream=stream_fn, launcher=launcher,
            count=count, wrapper=lambda w=wrapper, a=data, b=idx: w(a, b),
            library=lambda a=data, b=idx, d=dim: torch.gather(a, d, b))
        steps[pid] = {name: cs.host_us(fn) for name, fn in cases.items()}
    # the kernel's own device time, and P7 at one row: a launch of one
    # block of 128 threads that moves 1.5 KB
    one = dict(data=x["data_h"][:1].contiguous(),
               idx=x["idx_h"][:1].contiguous())
    device_ms = dict(
        P6=cs.kernel_device_ms(lambda: pg.gather_sublane(x["data_g"],
                                                         x["idx_g"])),
        P7=cs.kernel_device_ms(lambda: pg.gather_lane(x["data_h"],
                                                      x["idx_h"])),
        P7_one_row=cs.kernel_device_ms(lambda: pg.gather_lane(one["data"],
                                                              one["idx"])),
        P6_library=cs.kernel_device_ms(
            lambda: torch.gather(x["data_g"], 0, x["idx_g"])),
        P7_library=cs.kernel_device_ms(
            lambda: torch.gather(x["data_h"], 1, x["idx_h"])))
    return dict(tree=os.path.abspath(tree), host_us=steps,
                device_ms=device_ms, calls=cs.HOST_CALLS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout to measure (default: this one)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("host_steps: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    print(json.dumps(measure(args.tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
