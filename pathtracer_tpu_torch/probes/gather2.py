"""Gather probes P6-P9: the per-lane gathers the TPU had to decompose.

Port of the TPU Pallas probes in ``tools/probe_pallas_gather2.py``, at
its shapes: S = 64 index rows of 128 lanes, a (C, 128) = (548, 128) f32
table, and a (128, 128) table for the one-hot product.

  P6  gather_sublane(data, idx)  out[s, l] = data[idx[s, l], l]
  P7  gather_lane(data, idx)     out[s, l] = data[s, idx[s, l]]
  P8  gather_two_step(flat2, idx)  the TPU body ``k_two`` as written:
      chunk = idx >> 7, lp = idx & 127, cas[s, l] = chunk[s, lp[s, l]],
      t2[s, l] = flat2[cas[s, l], l], out[s, l] = t2[s, lp[s, l]]. This
      is not the tool's own reference ``flat[idx]`` (it agrees only where
      a row's lanes share their chunk); the port computes what the TPU
      kernel computes.
  P9  onehot_matmul(tbl, idx)    onehot(idx) @ tbl, as (S, 128, 128); the
      kernel writes the FP32 product's closed form (a row copy, NaN in a
      column with an inf or NaN elsewhere; csrc/gather_probe2.cu)

Each wrapper launches its CUDA kernel (``csrc/gather_probe2.cu``) for
CUDA tensors and runs its plain PyTorch version for CPU tensors; a CUDA
input the kernel cannot take raises. ``run_probes`` is the probe's entry
point, as the tool's script is: it makes the tool's inputs from
``default_rng(0)`` and runs P6-P9 once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda import _build

C, S, L = 548, 64, 128  # table rows (chunks), index rows, lane width

SOURCE = "gather_probe2.cu"

# kernel launches by wrapper (CPU calls never count)
LAUNCHES = {"gather_sublane": 0, "gather_lane": 0, "gather_two_step": 0,
            "onehot_matmul": 0}

# each launcher's signature (ops/cuda/_build.bind)
SIGNATURES = {"gather_sublane": "ppiipp", "gather_lane": "ppipp",
              "gather_two_step": "ppiipp", "onehot_matmul": "ppipp"}

_fns = None


def build(verbose: bool = False) -> str:
    """Compile csrc/gather_probe2.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
    return _fns


# --- plain versions


def gather_sublane_plain(data, idx):
    return torch.gather(data, 0, idx.long())


def gather_lane_plain(data, idx):
    return torch.gather(data, 1, idx.long())


def gather_two_step_plain(flat2, idx):
    idx = idx.long()
    lp = idx & (L - 1)
    cas = torch.take_along_dim(idx >> 7, lp, dim=1)
    t2 = torch.take_along_dim(flat2, cas, dim=0)
    return torch.take_along_dim(t2, lp, dim=1)


def onehot_matmul_plain(tbl, idx):
    onehot = F.one_hot(idx.long().reshape(-1), L).to(tbl.dtype)
    return (onehot @ tbl).reshape(idx.shape[0], L, L)


# --- wrappers

F32, I32 = torch.float32, torch.int32


def _lane_args(what: str, table, idx, table_rows=None):
    """Check a (rows, 128) f32 table (of ``table_rows`` rows where given)
    and (S, 128) i32 indices. Returns (the CUDA device's index, or -1 for
    CPU tensors; S)."""
    try:  # the case a launch takes, in the fewest attribute reads
        dev, shape, tshape = table.get_device(), idx.shape, table.shape
        if table.dtype is F32 and idx.dtype is I32 and table.is_cuda \
                and idx.get_device() == dev and table.is_contiguous() \
                and idx.is_contiguous() and len(shape) == 2 == len(tshape) \
                and shape[1] == L == tshape[1] \
                and table_rows in (None, tshape[0]):
            return dev, shape[0]
    except AttributeError:  # not a tensor: check raises for it
        pass
    dev = _build.check(what, dict(table=table, idx=idx),
                       dict(table=F32, idx=I32))
    if table.dim() != 2 or table.shape[1] != L or idx.dim() != 2 \
            or idx.shape[1] != L:
        raise ValueError(f"table must be (rows, {L}) and idx (S, {L}), got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if table_rows is not None and table.shape[0] != table_rows:
        raise ValueError(f"table must have {table_rows} rows, got "
                         f"{table.shape[0]}")
    return dev, idx.shape[0]


def gather_sublane(data, idx):
    """P6: (C, 128) f32 data, (S, 128) i32 idx in [0, C) -> (S, 128)."""
    dev, s = _lane_args("gather_sublane", data, idx)
    if dev < 0:
        return gather_sublane_plain(data, idx)
    out = torch.empty_like(idx, dtype=F32)
    if s:
        _build.launch((_fns or _load())["gather_sublane"], "gather_sublane",
                      dev, data.data_ptr(), idx.data_ptr(), s, data.shape[0],
                      out.data_ptr())
        LAUNCHES["gather_sublane"] += 1
    return out


def gather_lane(data, idx):
    """P7: (S, 128) f32 data, (S, 128) i32 idx in [0, 128) -> (S, 128)."""
    dev, s = _lane_args("gather_lane", data, idx, table_rows=idx.shape[0])
    if dev < 0:
        return gather_lane_plain(data, idx)
    out = torch.empty_like(data)
    if s:
        _build.launch((_fns or _load())["gather_lane"], "gather_lane", dev,
                      data.data_ptr(), idx.data_ptr(), s, out.data_ptr())
        LAUNCHES["gather_lane"] += 1
    return out


def gather_two_step(flat2, idx):
    """P8: (C, 128) f32 flat2, (S, 128) i32 idx in [0, 128 C) -> (S, 128),
    the TPU kernel's composite (module docstring)."""
    dev, s = _lane_args("gather_two_step", flat2, idx)
    if dev < 0:
        return gather_two_step_plain(flat2, idx)
    out = torch.empty_like(idx, dtype=F32)
    if s:
        _build.launch((_fns or _load())["gather_two_step"], "gather_two_step",
                      dev, flat2.data_ptr(), idx.data_ptr(), s,
                      flat2.shape[0], out.data_ptr())
        LAUNCHES["gather_two_step"] += 1
    return out


def onehot_matmul(tbl, idx, out=None):
    """P9: (128, 128) f32 tbl, (S, 128) i32 idx in [0, 128) ->
    onehot(idx) @ tbl as (S, 128, 128). ``out``, where given, is the
    CUDA output buffer to write (a timing loop reuses one). The kernel
    reads and writes 16 bytes at a time, so a CUDA ``tbl`` and ``out``
    must be 16-byte aligned."""
    dev, s = _lane_args("onehot_matmul", tbl, idx, table_rows=L)
    if dev < 0:
        return onehot_matmul_plain(tbl, idx)
    if out is None:
        out = torch.empty(s, L, L, dtype=F32, device=tbl.device)
    elif out.shape != (s, L, L) or out.dtype != F32 or \
            out.device != tbl.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {(s, L, L)} float32 "
                         f"tensor on {tbl.device}")
    tbl_ptr = tbl.data_ptr()
    if tbl_ptr % 16 or out.data_ptr() % 16:
        raise ValueError("tbl and out must be 16-byte aligned")
    if s:
        _build.launch((_fns or _load())["onehot_matmul"], "onehot_matmul",
                      dev, tbl_ptr, idx.data_ptr(), s * L, out.data_ptr())
        LAUNCHES["onehot_matmul"] += 1
    return out


# --- the probe


def probe_inputs(device="cuda") -> dict:
    """The TPU probe's inputs, in its draw order from ``default_rng(0)``:
    data_g, idx_g, data_h, idx_h, flat, idx_i, tbl_j, idx_j; plus flat2,
    flat as (C, 128)."""
    rng = np.random.default_rng(0)
    arrays = dict(
        data_g=rng.random((C, L), np.float32),
        idx_g=rng.integers(0, C, (S, L)).astype(np.int32),
        data_h=rng.random((S, L), np.float32),
        idx_h=rng.integers(0, L, (S, L)).astype(np.int32),
        flat=rng.random(C * L, np.float32),
        idx_i=rng.integers(0, C * L, (S, L)).astype(np.int32),
        tbl_j=rng.random((L, L), np.float32),
        idx_j=rng.integers(0, L, (S, L)).astype(np.int32))
    arrays["flat2"] = arrays["flat"].reshape(C, L)
    return {k: torch.as_tensor(a, device=device) for k, a in arrays.items()}


def special_inputs(rows: int = S, device="cuda") -> dict:
    """A P9 table of special values and (rows, 128) indices, from
    ``default_rng(1)``: column 3 all negative; column 4 all negative but
    -0 at row 9; -0 at row 7, column 5; +inf only at row 11, column 20;
    -inf only at row 13, column 30; NaN only at row 17, column 40; +inf
    at row 19 and NaN at row 23 in column 50; +0 at row 25, column 61;
    row 27 -0 from column 64 on. The first lanes of the indices name
    those rows, the rest are random. Returns dict(tbl, idx)."""
    rng = np.random.default_rng(1)
    tbl = rng.normal(size=(L, L)).astype(np.float32)
    tbl[:, 3] = -np.abs(tbl[:, 3]) - 0.5
    tbl[:, 4] = -np.abs(tbl[:, 4]) - 0.5
    tbl[9, 4] = tbl[7, 5] = -0.0
    tbl[11, 20], tbl[13, 30], tbl[17, 40] = np.inf, -np.inf, np.nan
    tbl[19, 50], tbl[23, 50] = np.inf, np.nan
    tbl[25, 61] = 0.0
    tbl[27, 64:] = -0.0
    idx = rng.integers(0, L, (rows, L)).astype(np.int32)
    idx[0, :9] = (7, 9, 11, 13, 17, 19, 23, 25, 27)  # the special rows
    return dict(tbl=torch.as_tensor(tbl, device=device),
                idx=torch.as_tensor(idx, device=device))


def equal_off_nan(a, b) -> bool:
    """NaN in the same places, and equal values with equal sign bits
    elsewhere (so -0 differs from +0)."""
    nan = a.isnan()
    if a.shape != b.shape or not torch.equal(nan, b.isnan()):
        return False
    a, b = a[~nan], b[~nan]
    return torch.equal(a, b) and torch.equal(a.signbit(), b.signbit())


PROBES = {
    "P6": lambda x: gather_sublane(x["data_g"], x["idx_g"]),
    "P7": lambda x: gather_lane(x["data_h"], x["idx_h"]),
    "P8": lambda x: gather_two_step(x["flat2"], x["idx_i"]),
    "P9": lambda x: onehot_matmul(x["tbl_j"], x["idx_j"]),
}

PLAIN = {
    "P6": lambda x: gather_sublane_plain(x["data_g"], x["idx_g"]),
    "P7": lambda x: gather_lane_plain(x["data_h"], x["idx_h"]),
    "P8": lambda x: gather_two_step_plain(x["flat2"], x["idx_i"]),
    "P9": lambda x: onehot_matmul_plain(x["tbl_j"], x["idx_j"]),
}


def run_probes(device="cuda", inputs: dict | None = None) -> dict:
    """Run P6-P9 once on ``device`` at the probe's shapes. Returns
    {probe id: output}."""
    x = probe_inputs(device) if inputs is None else inputs
    return {pid: fn(x) for pid, fn in PROBES.items()}
