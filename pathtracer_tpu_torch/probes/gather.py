"""Gather probes P1-P5: the BVH32 traversal's two memory operations.

Port of the TPU Pallas probes in ``tools/probe_pallas_gather.py``. Kernel
K2 does two things on every step besides arithmetic: it fetches one row of
a resident table at a per-lane index, and it pushes to and pops from a
short per-lane stack at a dynamic index. These probes do only that, at the
TPU probe's shapes: an (M, W) = (65,536, 8) f32 table, N = 8,192 lanes, a
stack D = 64 deep.

  P1 / P2  gather_rows(table, idx)      out[n] = table[idx[n]]
           (P1 ``k_take`` and P2 ``k_getitem`` compute the same function;
           only their TPU idiom differed, so both map to one kernel)
  P3       gather_cols(table_t, idx)    out[:, n] = table_t[:, idx[n]]
  P4       gather_rows_warp(table, idx) as P1, one warp per row
  P5       stack_push_read(sp, v)       push v[n] at sp[n], read it back

Each wrapper launches its CUDA kernel (``csrc/gather_probe.cu``) for CUDA
tensors and runs its plain PyTorch version for CPU tensors; a CUDA input
the kernel cannot take raises. ``run_probes`` is the probe's entry point,
as the tool's script is: it makes the tool's inputs from
``default_rng(0)`` and runs P1-P5 once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.cuda import _build

M, W = 65536, 8  # table rows, row width
N = 8192         # lanes
D = 64           # stack depth

SOURCE = "gather_probe.cu"

# kernel launches by wrapper (CPU calls never count)
LAUNCHES = {"gather_rows": 0, "gather_cols": 0, "gather_rows_warp": 0,
            "stack_push_read": 0}

_fns = None


def build(verbose: bool = False) -> str:
    """Compile csrc/gather_probe.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        _fns = _build.load_cuda(SOURCE, {
            "pt_gather_rows_launch": (vp, vp, i, i, i, vp, vp),
            "pt_gather_cols_launch": (vp, vp, i, i, i, vp, vp),
            "pt_gather_rows_warp_launch": (vp, vp, i, i, i, vp, vp),
            "pt_stack_push_read_launch": (vp, vp, i, i, vp, vp),
        })
    return _fns


# --- plain versions


def gather_rows_plain(table, idx):
    return table[idx.long()]


def gather_cols_plain(table_t, idx):
    return table_t[:, idx.long()]


def stack_push_read_plain(sp, v, depth: int = D):
    stack = torch.zeros((depth, v.shape[0]), dtype=v.dtype, device=v.device)
    stack.scatter_(0, sp.long()[None], v[None])
    return stack.gather(0, sp.long()[None])[0]


# --- wrappers


def _launch(kernel: str, dev, out, *args):
    """Launch ``pt_<kernel>_launch(*args, out)`` on ``dev`` and count it."""
    _build.launch(_load()[f"pt_{kernel}_launch"], kernel, dev, *args,
                  out.data_ptr())
    LAUNCHES[kernel] += 1
    return out


def _rows_args(what: str, table, idx):
    dev = _build.check(what, dict(table=table, idx=idx),
                       dict(table=torch.float32, idx=torch.int32))
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be (M, W) and idx (N,), got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    return dev, idx.shape[0], table.shape[0], table.shape[1]


def gather_rows(table, idx):
    """P1 / P2: (M, W) f32 table, (N,) i32 idx -> (N, W)."""
    dev, n, m, w = _rows_args("gather_rows", table, idx)
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    out = torch.empty(n, w, dtype=torch.float32, device=dev)
    return _launch("gather_rows", dev, out,
                   table.data_ptr(), idx.data_ptr(), n, m, w)


def gather_rows_warp(table, idx):
    """P4: as gather_rows, one warp per output row."""
    dev, n, m, w = _rows_args("gather_rows_warp", table, idx)
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    out = torch.empty(n, w, dtype=torch.float32, device=dev)
    return _launch("gather_rows_warp", dev, out,
                   table.data_ptr(), idx.data_ptr(), n, m, w)


def gather_cols(table_t, idx):
    """P3: (W, M) f32 column-major table, (N,) i32 idx -> (W, N)."""
    dev, n, w, m = _rows_args("gather_cols", table_t, idx)
    if not table_t.is_cuda:
        return gather_cols_plain(table_t, idx)
    out = torch.empty(w, n, dtype=torch.float32, device=dev)
    return _launch("gather_cols", dev, out,
                   table_t.data_ptr(), idx.data_ptr(), n, m, w)


def stack_push_read(sp, v, depth: int = D):
    """P5: (N,) i32 stack pointers in [0, depth), (N,) f32 values ->
    (N,) f32, each value read back from where it was pushed."""
    dev = _build.check("stack_push_read", dict(sp=sp, v=v),
                       dict(sp=torch.int32, v=torch.float32))
    if sp.dim() != 1 or tuple(v.shape) != tuple(sp.shape):
        raise ValueError(f"sp and v must be (N,), got {tuple(sp.shape)}, "
                         f"{tuple(v.shape)}")
    if not 1 <= depth <= D:
        raise ValueError(f"depth must be in [1, {D}], got {depth}")
    if not sp.is_cuda:
        return stack_push_read_plain(sp, v, depth)
    out = torch.empty(v.shape[0], dtype=torch.float32, device=dev)
    return _launch("stack_push_read", dev, out,
                   sp.data_ptr(), v.data_ptr(), v.shape[0], depth)


# --- the probe


def probe_inputs(device="cuda") -> dict:
    """The TPU probe's inputs, in its draw order from ``default_rng(0)``:
    table (M, W), idx (N,), table_t (W, M), sp (N,) and v (N,)."""
    rng = np.random.default_rng(0)
    table = rng.random((M, W), np.float32)
    idx = rng.integers(0, M, N).astype(np.int32)
    sp = rng.integers(0, D, N).astype(np.int32)
    v = rng.random(N).astype(np.float32)
    return {k: torch.as_tensor(a, device=device) for k, a in dict(
        table=table, idx=idx, table_t=np.ascontiguousarray(table.T), sp=sp,
        v=v).items()}


PROBES = {
    "P1": lambda x: gather_rows(x["table"], x["idx"]),
    "P2": lambda x: gather_rows(x["table"], x["idx"]),
    "P3": lambda x: gather_cols(x["table_t"], x["idx"]),
    "P4": lambda x: gather_rows_warp(x["table"], x["idx"]),
    "P5": lambda x: stack_push_read(x["sp"], x["v"]),
}

PLAIN = {
    "P1": lambda x: gather_rows_plain(x["table"], x["idx"]),
    "P2": lambda x: gather_rows_plain(x["table"], x["idx"]),
    "P3": lambda x: gather_cols_plain(x["table_t"], x["idx"]),
    "P4": lambda x: gather_rows_plain(x["table"], x["idx"]),
    "P5": lambda x: stack_push_read_plain(x["sp"], x["v"]),
}


def run_probes(device="cuda", inputs: dict | None = None) -> dict:
    """Run P1-P5 once on ``device`` at the probe's shapes. Returns
    {probe id: output}."""
    x = probe_inputs(device) if inputs is None else inputs
    return {pid: fn(x) for pid, fn in PROBES.items()}
