"""Gather probes P1-P5: the BVH32 traversal's two memory operations.

Port of the TPU Pallas probes in ``tools/probe_pallas_gather.py``. Kernel
K2 does two things on every step besides arithmetic: it fetches one row of
a resident table at a per-lane index, and it pushes to and pops from a
short per-lane stack at a dynamic index. These probes do only that, at the
TPU probe's shapes: an (M, W) = (65,536, 8) f32 table, N = 8,192 lanes, a
stack D = 64 deep.

  P1 / P2  gather_rows(table, idx)      out[n] = table[idx[n]]
           (P1 ``k_take`` and P2 ``k_getitem`` compute the same function;
           only their TPU idiom differed, so both map to one kernel: at
           W = 8 on 16-byte aligned pointers one thread per float4 of the
           output, else one thread per word on a 2-D grid of lanes by
           columns)
  P3       gather_cols(table_t, idx)    out[:, n] = table_t[:, idx[n]]
           (one thread per lane, its W loads in flight together)
  P4       gather_rows_warp(table, idx) as P1, a warp per run of P4_ROWS
           rows: the run's indices loaded once, one a lane, and each sent
           by shuffle to the pair of lanes that copies its row, a float4
           a lane (W = 8 on aligned pointers; else the warp copies a row
           at a time)
  P5       stack_push_read(sp, v)       push v[n] at sp[n], read it back
           (each thread's stack a column of a slab in shared memory)

Each wrapper launches its CUDA kernel (``csrc/gather_probe.cu``) for CUDA
tensors and runs its plain PyTorch version for CPU tensors; a CUDA input
the kernel cannot take raises. ``run_probes`` is the probe's entry point,
as the tool's script is: it makes the tool's inputs from
``default_rng(0)`` and runs P1-P5 once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import _build

M, W = 65536, 8  # table rows, row width
N = 8192         # lanes
D = 64           # stack depth

SOURCE = "gather_probe.cu"

# kernel launches by wrapper (``_build.launch`` counts them;
# CPU calls never launch)
LAUNCHES = {"gather_rows": 0, "gather_cols": 0, "gather_rows_warp": 0,
            "stack_push_read": 0}

# each launcher's signature (ops/cuda/_build.bind)
SIGNATURES = {"gather_rows": "ppiiipp", "gather_cols": "ppiiipp",
              "gather_rows_warp": "ppiiipp", "stack_push_read": "ppiipp"}
_build.counted(__name__, SIGNATURES)

_fns = None


def macro(name: str) -> int:
    """A tuning constant of the default build: the value of ``#define
    name`` in the source."""
    return _build.macro(SOURCE, name)


def threads(kernel: str) -> int:
    """Threads a block of ``gather_rows`` ("P1"), ``gather_cols`` ("P3"),
    ``gather_rows_warp`` ("P4") or ``stack_push_read`` ("P5") in the
    default build: the source's P1_THREADS ... P5_THREADS. P5's stack slab
    takes ``4 * depth * threads("P5")`` bytes of shared memory a block;
    a warp of P4 copies ``macro("P4_ROWS")`` rows."""
    return macro(f"{kernel}_THREADS")


def build(verbose: bool = False) -> str:
    """Compile csrc/gather_probe.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
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

F32, I32 = torch.float32, torch.int32


def _rows_args(what: str, table, idx):
    """Check a 2-D f32 table and (N,) i32 indices. Returns (the CUDA
    device's index, or -1 for CPU tensors; N; the table's two sizes)."""
    try:  # the case a launch takes, in the fewest attribute reads
        dev, shape, tshape = table.get_device(), idx.shape, table.shape
        if table.dtype is F32 and idx.dtype is I32 and table.is_cuda \
                and idx.get_device() == dev and table.is_contiguous() \
                and idx.is_contiguous() and len(tshape) == 2 \
                and len(shape) == 1:
            return dev, shape[0], tshape[0], tshape[1]
    except AttributeError:  # not a tensor: check raises for it
        pass
    dev = _build.check(what, dict(table=table, idx=idx),
                       dict(table=F32, idx=I32))
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be (M, W) and idx (N,), got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    return dev, idx.shape[0], table.shape[0], table.shape[1]


def gather_rows(table, idx):
    """P1 / P2: (M, W) f32 table, (N,) i32 idx -> (N, W)."""
    dev, n, m, w = _rows_args("gather_rows", table, idx)
    if dev < 0:
        return gather_rows_plain(table, idx)
    out = torch.empty(n, w, dtype=F32, device=table.device)
    if out.numel():
        _build.launch((_fns or _load())["gather_rows"], "gather_rows", dev,
                      table.data_ptr(), idx.data_ptr(), n, m, w,
                      out.data_ptr())
    return out


def gather_rows_warp(table, idx):
    """P4: as gather_rows, a warp per run of P4_ROWS output rows."""
    dev, n, m, w = _rows_args("gather_rows_warp", table, idx)
    if dev < 0:
        return gather_rows_plain(table, idx)
    out = torch.empty(n, w, dtype=F32, device=table.device)
    if out.numel():
        _build.launch((_fns or _load())["gather_rows_warp"],
                      "gather_rows_warp", dev, table.data_ptr(),
                      idx.data_ptr(), n, m, w, out.data_ptr())
    return out


def gather_cols(table_t, idx):
    """P3: (W, M) f32 column-major table, (N,) i32 idx -> (W, N)."""
    dev, n, w, m = _rows_args("gather_cols", table_t, idx)
    if dev < 0:
        return gather_cols_plain(table_t, idx)
    out = torch.empty(w, n, dtype=F32, device=table_t.device)
    if out.numel():
        _build.launch((_fns or _load())["gather_cols"], "gather_cols", dev,
                      table_t.data_ptr(), idx.data_ptr(), n, m, w,
                      out.data_ptr())
    return out


def stack_push_read(sp, v, depth: int = D):
    """P5: (N,) i32 stack pointers in [0, depth), (N,) f32 values ->
    (N,) f32, each value read back from where it was pushed."""
    try:  # the case a launch takes, in the fewest attribute reads
        dev, shape = sp.get_device(), sp.shape
        fast = sp.dtype is I32 and v.dtype is F32 and sp.is_cuda \
            and v.get_device() == dev and sp.is_contiguous() \
            and v.is_contiguous() and len(shape) == 1 and v.shape == shape
    except AttributeError:  # not a tensor: check raises for it
        fast = False
    if not fast:
        dev = _build.check("stack_push_read", dict(sp=sp, v=v),
                           dict(sp=I32, v=F32))
        if sp.dim() != 1 or tuple(v.shape) != tuple(sp.shape):
            raise ValueError(f"sp and v must be (N,), got "
                             f"{tuple(sp.shape)}, {tuple(v.shape)}")
    if not 1 <= depth <= D:
        raise ValueError(f"depth must be in [1, {D}], got {depth}")
    if dev < 0:
        return stack_push_read_plain(sp, v, depth)
    out = torch.empty_like(v)
    if out.numel():
        _build.launch((_fns or _load())["stack_push_read"], "stack_push_read",
                      dev, sp.data_ptr(), v.data_ptr(), out.shape[0], depth,
                      out.data_ptr())
    return out


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
