"""Stratified and uniform-random samplers, stateless and wave-parallel.

Port of ``pathtracer_tpu/ops/samplers.py``: every draw is a hash of
(pixel, dimension, sample index), so a whole wave draws one dimension at
once and any sample is reproducible alone. The stratified sampler puts
sample s of a pixel in stratum perm(s) with a keyed permutation per
(pixel, dimension); its 2D pairs tile a grid, and ``lhs_2d_dim`` gives
the latin-hypercube arrays of the all-lights strategy.

32-bit words ride as int64 tensors holding values in [0, 2^32), as in
``ops/sobol.py`` (PyTorch's uint32 lacks ops on the CPU): every add and
multiply is masked back to 32 bits, and a multiply by a constant of 32
bits is split in two halves so no int64 product overflows. The results
are the JAX package's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math import ONE_MINUS_EPSILON

MASK32 = 0xFFFFFFFF
_ONE_MINUS = float(ONE_MINUS_EPSILON)


def _mul32(a, c: int):
    """(a * c) mod 2^32 for words ``a`` (tensor) and a constant ``c``,
    each partial product below 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _u32(x):
    """A tensor of integers (negative ones included) as its 32-bit words,
    two's complement, in int64."""
    return x.to(torch.int64) & MASK32


def hash_u32(x):
    """PCG-style integer hash (u32 -> u32), elementwise."""
    x = (_mul32(x, 747796405) + 2891336453) & MASK32
    word = _mul32(((x >> ((x >> 28) + 4)) ^ x), 277803737)
    return (word >> 22) ^ word


def hash_combine(a, b):
    """hash_u32(a ^ (b * 0x9E3779B9)); ``b`` a tensor or a Python int."""
    if isinstance(b, int):
        return hash_u32(a ^ ((b * 0x9E3779B9) & MASK32))
    return hash_u32(a ^ _mul32(b, 0x9E3779B9))


def uniform_from_hash(h):
    """u32 hash -> float in [0, 1) (round to nearest, as u32 -> f32)."""
    return torch.clamp_max(h.to(torch.float32) * float(2.0 ** -32),
                           _ONE_MINUS)


def _round_hashes(key):
    """The three round hashes of ``_permute_pow2``'s key."""
    return [hash_u32((key + ((r * 0x85EBCA6B) & MASK32)) & MASK32)
            for r in range(3)]


def _permute_rounds(x, log2_n: int, hashes):
    mask = (1 << log2_n) - 1
    shift = max(1, log2_n // 2)
    x = x & mask
    for h in hashes:
        x = x ^ (h & mask)
        # key-derived odd multiplier: odd => bijective mod 2^k
        x = (x * ((h >> 8) | 1)) & mask
        x = x ^ (x >> shift)
    return x & mask


def _permute_pow2(index, log2_n: int, key):
    """Keyed bijection on [0, 2^log2_n): rounds of xor-const, odd-multiply
    and xorshift, each invertible on the k-bit domain."""
    if log2_n == 0:
        return torch.zeros_like(key)
    return _permute_rounds(index, log2_n, _round_hashes(key))


def _frame_word(frame: int, offset: int) -> int:
    return (frame + offset) & MASK32


def stratified_sample_dim(pixel_hash, frame: int, spp_log2: int, dim: int):
    """One stratified-jittered dimension for the whole wave.

    pixel_hash: (N,) words; frame: the sample index; spp_log2: log2 of
    the render's samples per pixel; dim: the dimension. Sample s lands in
    stratum perm(s), jittered, with a permutation per (pixel, dimension).
    """
    key = hash_combine(pixel_hash, (dim * 0x68BC21EB) & MASK32)
    stratum = _permute_pow2(torch.full_like(key, frame & MASK32), spp_log2,
                            key)
    jitter = uniform_from_hash(hash_combine(key,
                                            _frame_word(frame, 0x02E5BE93)))
    inv = float(np.float32(1.0 / (1 << spp_log2)))
    return torch.clamp_max((stratum.to(torch.float32) + jitter) * inv,
                           _ONE_MINUS)


def stratified_sample_dim2(pixel_hash, frame: int, spp_log2: int, dim: int):
    """One stratified-jittered 2D pair for the whole wave -> (N, 2): the
    spp samples of a pixel tile a 2^ceil(l/2) x 2^floor(l/2) grid, one a
    cell, visited in a keyed permutation per (pixel, dimension pair)."""
    key = hash_combine(pixel_hash, (dim * 0x68BC21EB) & MASK32)
    cell = _permute_pow2(torch.full_like(key, frame & MASK32), spp_log2, key)
    ly = spp_log2 // 2
    lx = spp_log2 - ly
    cx = cell & ((1 << lx) - 1)
    cy = cell >> lx
    jx = uniform_from_hash(hash_combine(key, _frame_word(frame, 0x02E5BE93)))
    jy = uniform_from_hash(hash_combine(key, _frame_word(frame, 0x63D83595)))
    x = torch.clamp_max((cx.to(torch.float32) + jx)
                        * float(np.float32(0.5 ** lx)), _ONE_MINUS)
    y = torch.clamp_max((cy.to(torch.float32) + jy)
                        * float(np.float32(0.5 ** ly)), _ONE_MINUS)
    return torch.stack([x, y], dim=-1)


def permute_general(index, n: int, key):
    """Keyed bijection on [0, n) for any n: the pow2 bijection over the
    next power of two, cycle-walked until the image lands inside.

    The reference walks in a ``lax.while_loop`` on ``any(x >= n)``, a
    host sync a pass in eager torch. A walk from a point inside the
    domain visits each point outside it at most once, so after the first
    permutation 2^log2 - n further steps that move only the lanes still
    outside give the same bits with no sync.
    """
    if n <= 1:
        return torch.zeros_like(key)
    log2 = int(np.ceil(np.log2(n)))
    hashes = _round_hashes(key)
    x = _permute_rounds(index, log2, hashes)
    for _ in range((1 << log2) - n):
        x = torch.where(x >= n, _permute_rounds(x, log2, hashes), x)
    return x


def lhs_2d_dim(pixel_hash, frame: int, dim: int, i: int, n: int):
    """The i-th of the n latin-hypercube 2D points of this pixel sample:
    across i = 0..n-1 each x stratum and each y stratum is hit once.
    Permutations keyed by (pixel, frame, dim, axis). Returns (N, 2)."""
    base = hash_combine(pixel_hash, (dim * 0x68BC21EB) & MASK32)
    key = hash_combine(base, _frame_word(frame, 0x1B873593))
    idx = torch.full_like(key, i & MASK32)
    sx = permute_general(idx, n, key)
    sy = permute_general(idx, n, hash_u32((key + 0x5BD1E995) & MASK32))
    jx = uniform_from_hash(hash_combine(key, (2 * i) & MASK32))
    jy = uniform_from_hash(hash_combine(key, (2 * i + 1) & MASK32))
    inv = float(np.float32(1.0 / n))
    x = torch.clamp_max((sx.to(torch.float32) + jx) * inv, _ONE_MINUS)
    y = torch.clamp_max((sy.to(torch.float32) + jy) * inv, _ONE_MINUS)
    return torch.stack([x, y], dim=-1)


def random_sample_dim(pixel_hash, frame: int, dim: int):
    """Plain uniform sample of one dimension for the whole wave."""
    key = hash_combine(pixel_hash, (dim * 0x68BC21EB) & MASK32)
    return uniform_from_hash(hash_combine(key,
                                          _frame_word(frame, 0x02E5BE93)))


def pixel_hash(px, py):
    """Per-pixel seed of the hash samplers from (N,) integer pixel
    coordinates (negative ones as their two's-complement words)."""
    return hash_combine(_u32(px), hash_u32(_u32(py)))
