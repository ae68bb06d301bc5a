"""Sobol' samples of a pixel's sample frames, as pbrt-v3's SobolSampler
draws them (``SobolIntervalToIndex`` and ``SobolSample``).

The sample rectangle ``[p_min, p_max)`` is covered by a square of
``resolution = 2^m`` pixels a side. Frame ``f`` of the pixel (x, y)
(relative to ``p_min``) is the sequence's index

    index = (f << 2m) ^ XOR{ vdc_inv[m-1][c] : bit c of ((x << m | y) ^ delta) }
    delta = XOR{ vdc[m-1][c] : bit c of f }

and dimension ``k`` of that sample is the XOR of the generator matrix's
columns ``sm32[k][b]`` over the bits ``b`` of the index, XORed with the
pixel's scramble word (the Cantor pairing of its shifted coordinates),
over 2^32 and held below 1. Dimensions 0 and 1 (the position inside the
pixel) are drawn without the scramble and mapped into the pixel.

The three tables in ``assets/`` are the published generator matrices
(the first 1024 dimensions of Joe and Kuo's, as pbrt ships them) and
pbrt's Van der Corput tables derived from them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
MATRIX_BITS = 52
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
HALF_MAX_I32 = (2 ** 31 - 1) // 2
_TABLES: dict = {}


def tables() -> dict:
    if not _TABLES:
        for name in ("sobol_32", "sobol_vdc", "sobol_vdc_inv"):
            _TABLES[name] = np.load(os.path.join(ASSETS, name + ".npy"))
    return _TABLES


def round_up_pow2(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


class Domain:
    """The square of 2^m pixels over the sample rectangle."""

    def __init__(self, p_min, p_max):
        self.p_min = (int(p_min[0]), int(p_min[1]))
        extent = max(p_max[0] - p_min[0], p_max[1] - p_min[1])
        self.resolution = round_up_pow2(extent)
        self.m = self.resolution.bit_length() - 1

    def scramble(self, px: np.ndarray, py: np.ndarray) -> np.ndarray:
        """The pixels' scramble words (int64, below 2^32)."""
        sx = np.asarray(px, np.int64) + HALF_MAX_I32
        sy = np.asarray(py, np.int64) + HALF_MAX_I32
        s = (sx + sy).astype(np.uint64)
        with np.errstate(over="ignore"):
            cantor = s * (s + np.uint64(1)) // np.uint64(2) \
                + sy.astype(np.uint64)
        return (cantor & np.uint64(0xFFFFFFFF)).astype(np.int64)

    def index(self, px: np.ndarray, py: np.ndarray,
              frame: np.ndarray) -> np.ndarray:
        """The sequence index (int64) of each (pixel, frame) pair."""
        m = self.m
        vdc = tables()["sobol_vdc"][m - 1].astype(np.int64)
        vdc_inv = tables()["sobol_vdc_inv"][m - 1].astype(np.int64)
        frame = np.asarray(frame, np.int64)
        delta = np.zeros_like(frame)
        for c in range(int(frame.max()).bit_length()):
            delta ^= np.where((frame >> c) & 1 == 1, vdc[c], 0)
        x = np.asarray(px, np.int64) - self.p_min[0]
        y = np.asarray(py, np.int64) - self.p_min[1]
        b = ((x << m) | y) ^ delta
        index = frame << (2 * m)
        for c in range(32):
            index ^= np.where((b >> c) & 1 == 1, vdc_inv[c], 0)
        return index


class Draws:
    """Sample values of a wave's lanes, by dimension."""

    def __init__(self, index: torch.Tensor, scramble: torch.Tensor):
        self.index = index
        self.scramble = scramble
        self.sm32 = tables()["sobol_32"].astype(np.int64)

    def raw(self, dim: int, scrambled: bool = True) -> torch.Tensor:
        col = self.sm32[min(dim, self.sm32.shape[0] - 1)]
        v = torch.zeros_like(self.index)
        for b in range(MATRIX_BITS):
            if col[b]:
                v ^= (-((self.index >> b) & 1)) & int(col[b])
        if scrambled:
            v ^= self.scramble
        return torch.clamp_max(v.to(torch.float32) * (2.0 ** -32),
                               ONE_MINUS_EPSILON)

    def one(self, dim: int) -> torch.Tensor:
        return self.raw(dim)

    def two(self, dim: int) -> torch.Tensor:
        return torch.stack([self.raw(dim), self.raw(dim + 1)], dim=-1)
