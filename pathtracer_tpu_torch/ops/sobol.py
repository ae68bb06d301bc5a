"""Sobol' low-discrepancy sampling as vectorized bit-matrix XOR ops.

Port of ``pathtracer_tpu/ops/sobol.py``. The tables are this package's
``assets/*.npy`` (byte-identical copies of the JAX package's), read by
file path with numpy. PyTorch has
no uint32 shifts or subtraction on the CPU, so 32-bit words ride as int64
tensors holding values in [0, 2^32); XOR and AND of such values stay in
range, and ``_to_unit`` converts them to float32 exactly as uint32 -> f32
does (round to nearest even). 64-bit sample indices stay (lo, hi) word
pairs, as in the reference.

The reference's 52-step masked-XOR chain becomes one (N, 52) "row entry
where the index bit is set" matrix reduced by XOR halving (six steps):
the same XOR of the same words, in a dozen tensor ops instead of ~200.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.math import (HALF_MAX_I32, ONE_MINUS_EPSILON, log2_int,
                         round_up_pow2)

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")

_tables_cache: dict[str, np.ndarray] = {}


def _load_tables():
    if not _tables_cache:
        for key, name in (("sm32", "sobol_32"), ("vdc", "sobol_vdc"),
                          ("vdc_inv", "sobol_vdc_inv")):
            _tables_cache[key] = np.load(os.path.join(_ASSET_DIR,
                                                      name + ".npy"))
    return _tables_cache


INV_2_POW_32 = np.float32(2.0 ** -32)


@dataclasses.dataclass(frozen=True)
class SobolDomain:
    """Static per-render Sobol configuration over [p_min, p_max)."""

    p_min: tuple[int, int]
    resolution: int
    m: int
    spp: int

    @staticmethod
    def create(p_min, p_max, samples_per_pixel: int) -> "SobolDomain":
        diag = (p_max[0] - p_min[0], p_max[1] - p_min[1])
        resolution = round_up_pow2(max(diag))
        m = log2_int(resolution) if resolution > 0 else 0
        if m > 16:
            raise ValueError("sobol domain resolution above 2^16 unsupported")
        spp = round_up_pow2(samples_per_pixel)
        return SobolDomain((int(p_min[0]), int(p_min[1])), resolution, m, spp)


def pixel_statics(domain: SobolDomain, px: np.ndarray, py: np.ndarray):
    """Host precompute of per-pixel constants (numpy).

    Returns (scramble (N,) u32, b_base (N,) u32), b_base = (x<<m)|y of the
    bounds-relative pixel.
    """
    x = np.asarray(px, np.int64) - domain.p_min[0]
    y = np.asarray(py, np.int64) - domain.p_min[1]
    sx = (np.asarray(px, np.int64) + int(HALF_MAX_I32)).astype(np.uint64)
    sy = (np.asarray(py, np.int64) + int(HALF_MAX_I32)).astype(np.uint64)
    with np.errstate(over="ignore"):
        s = sx + sy
        scramble = (s * (s + np.uint64(1)) // np.uint64(2) + sy)
    scramble_u32 = (scramble & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b_base = ((x.astype(np.uint64) << np.uint64(domain.m))
              | y.astype(np.uint64))
    return scramble_u32, b_base.astype(np.uint32)


def frame_statics(domain: SobolDomain, frame: int):
    """Host precompute for one sample index.

    Returns (shifted_lo, shifted_hi, delta) u32 host scalars:
    shifted = frame << 2m; delta = XOR of vdc rows over the frame's bits.
    """
    m = domain.m
    if m == 0:
        return np.uint32(0), np.uint32(0), np.uint32(0)
    vdc = _load_tables()["vdc"]
    shifted = np.uint64(frame) << np.uint64(2 * m)
    delta = np.uint64(0)
    f, c = int(frame), 0
    while f != 0:
        if f & 1:
            delta ^= vdc[m - 1][c]
        f >>= 1
        c += 1
    if delta >= (1 << 32):
        raise ValueError("frame index outside the 32-bit delta range")
    return (np.uint32(shifted & np.uint64(0xFFFFFFFF)),
            np.uint32(shifted >> np.uint64(32)), np.uint32(delta))


def vdc_inv_rows(domain: SobolDomain, device):
    """(52,) lo/hi word rows (int64 tensors) of the inverse-vdc row for m."""
    vdc_inv = _load_tables()["vdc_inv"]
    row = vdc_inv[domain.m - 1] if domain.m > 0 else np.zeros(52, np.uint64)
    lo = (row & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (row >> np.uint64(32)).astype(np.int64)
    return (torch.as_tensor(lo, device=device),
            torch.as_tensor(hi, device=device))


def sm32_device(device):
    """(1024, 52) Sobol generator matrix words as an int64 tensor."""
    return torch.as_tensor(_load_tables()["sm32"].astype(np.int64),
                           device=device)


def _xor_reduce(sel):
    """XOR of the columns of an (N, K) int64 tensor, by halving."""
    while sel.shape[-1] > 1:
        k = sel.shape[-1]
        if k % 2:
            sel = torch.cat([sel, torch.zeros_like(sel[..., :1])], dim=-1)
            k += 1
        sel = sel[..., :k // 2] ^ sel[..., k // 2:]
    return sel[..., 0]


def _index_bits(word, nbits: int):
    """(N,) word -> (N, nbits) int64 of its low bits, bit 0 first."""
    shifts = torch.arange(nbits, device=word.device, dtype=torch.int64)
    return (word[..., None] >> shifts) & 1


def _word(w):
    """A frame word as an XOR operand: a device tensor as it is, a host
    integer (numpy's included) as a Python int."""
    return w if isinstance(w, torch.Tensor) else int(w)


def sobol_index(b_base, delta, shifted_lo, shifted_hi, inv_lo, inv_hi):
    """Per-pixel 64-bit Sobol sample index as (lo, hi) words.

    b_base: (N,) int64 words; delta/shifted_*: the frame's words
    (frame_statics), host ints or 0-d int64 tensors on b_base's device
    (the same bits: a captured CUDA graph reads them from its buffers);
    inv_lo/hi: (52,) rows from vdc_inv_rows. Only the low 32 index bits
    can be set.
    """
    bits = _index_bits(b_base ^ _word(delta), 32)
    lo = _xor_reduce(bits * inv_lo[:32])
    hi = _xor_reduce(bits * inv_hi[:32])
    return lo ^ _word(shifted_lo), hi ^ _word(shifted_hi)


def _dim_value(idx_lo, idx_hi, rows):
    """XOR of each (52,) row's entries selected by the 52 index bits.
    rows: (52,) -> (N,) values, or (K, 52) -> (N, K)."""
    bits = torch.cat([_index_bits(idx_lo, 32), _index_bits(idx_hi, 20)],
                     dim=-1)
    if rows.dim() == 2:
        bits = bits[:, None, :]
    return _xor_reduce(bits * rows)


def _to_unit(v):
    return torch.clamp_max(v.to(torch.float32) * INV_2_POW_32,
                           float(ONE_MINUS_EPSILON))


def sobol_sample_dim(idx_lo, idx_hi, dim: int, scramble, sm32):
    """Sobol value in [0,1) for ONE dimension shared by the whole wave.

    idx_lo/hi: (N,) words from sobol_index; scramble: (N,) words; sm32:
    (1024, 52) from sm32_device. A dimension past the table's last reads
    the last row, as the reference's ``dynamic_slice`` clamps its start.
    """
    row = sm32[min(dim, sm32.shape[0] - 1)]
    return _to_unit(_dim_value(idx_lo, idx_hi, row) ^ scramble)


def sobol_sample_dim2(idx_lo, idx_hi, dim: int, scramble, sm32):
    """Two consecutive dimensions at once -> (N, 2); a pair starting past
    the table's last but one reads the last two rows (the clamp above)."""
    start = min(dim, sm32.shape[0] - 2)
    v = _dim_value(idx_lo, idx_hi, sm32[start:start + 2]) ^ \
        scramble[:, None]
    return _to_unit(v)
