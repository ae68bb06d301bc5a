"""Texture pool: mip pyramids packed into one flat tensor.

Port of ``pathtracer_tpu/scene/texture.py``. The host build is numpy, a
copy of the reference's: non-pow2 Lanczos resampling, the box-filter
pyramid, and every level of every texture concatenated into one
(total_texels, 3) array addressed through per-texture level tables. The
lookup (wrapped texel fetch, bilinear at one level, trilinear by filter
width) is plain torch gathers on the pool's device: the plain version of
kernels K3 / K4 (``ops/cuda/texture_cu.py``), whose packed descriptor
rows ``pack_descriptors`` builds.

Kept from the reference for parity: ``TexturePoolBuilder.add`` pads
each texture's level tables to MAX_LEVELS before ``build`` counts them,
so every texture reports ``n_levels == MAX_LEVELS`` and ``lookup_width``
puts a nonzero width MAX_LEVELS minus the texture's true level count
levels coarser than the pyramid's own count would (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math import log2_int, round_up_pow2

WRAP_REPEAT = 0
WRAP_BLACK = 1
WRAP_CLAMP = 2

MAX_LEVELS = 16

# The texture kernels' descriptor rows (``pack_descriptors``; read by
# csrc/texture.cu, whose #defines of the same names must agree): a row of
# TXF_WIDTH floats and one of TXI_WIDTH ints a descriptor, an image
# descriptor's pool level tables copied into its int row.
TXF_UV = 0  # su sv ou ov
TXF_RGB0 = 4
TXF_RGB1 = 7
TXF_SCALE = 10
TXF_WIDTH = 16
TXI_KIND = 0
TXI_SRGB = 1
TXI_CHANNEL = 2
TXI_NLEVELS = 3
TXI_WRAP = 4
TXI_OFFSET = 16  # MAX_LEVELS level offsets into the pool, in texels
TXI_W = TXI_OFFSET + MAX_LEVELS
TXI_H = TXI_W + MAX_LEVELS
TXI_WIDTH = TXI_H + MAX_LEVELS


def _lanczos(x: np.ndarray, tau: float = 2.0) -> np.ndarray:
    x = np.abs(x)
    out = np.zeros_like(x)
    small = x < 1e-5
    inside = (x <= 1.0) & ~small
    xp = np.pi * x[inside]
    out[inside] = (np.sin(xp * tau) / (xp * tau)) * (np.sin(xp) / xp)
    out[small] = 1.0
    return out


def _resample_axis(img: np.ndarray, new_res: int, wrap: int) -> np.ndarray:
    """Lanczos resample along axis 0."""
    old_res = img.shape[0]
    i = np.arange(new_res)
    center = (i + 0.5) * old_res / new_res
    first = np.floor(center - 2.0 + 0.5).astype(np.int64)
    offs = np.arange(4)
    pos = first[:, None] + offs[None, :] + 0.5
    w = _lanczos((pos - center[:, None]) / 2.0)
    w /= w.sum(axis=1, keepdims=True)
    idx = first[:, None] + offs[None, :]
    if wrap == WRAP_REPEAT:
        idx = np.mod(idx, old_res)
    elif wrap == WRAP_CLAMP:
        idx = np.clip(idx, 0, old_res - 1)
    else:
        w = np.where((idx < 0) | (idx >= old_res), 0.0, w)
        idx = np.clip(idx, 0, old_res - 1)
    return np.einsum("nk,nk...->n...", w, img[idx])


def build_pyramid(image: np.ndarray,
                  wrap: int = WRAP_REPEAT) -> list[np.ndarray]:
    """Pow2-resampled mip chain down to 1x1 (host numpy)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w = img.shape[:2]
    ph, pw = round_up_pow2(h), round_up_pow2(w)
    if (ph, pw) != (h, w):
        img = _resample_axis(img, ph, wrap)
        img = np.swapaxes(_resample_axis(np.swapaxes(img, 0, 1), pw, wrap),
                          0, 1)
    levels = [img.astype(np.float32)]
    n_levels = 1 + log2_int(max(ph, pw))
    for _ in range(1, n_levels):
        prev = levels[-1]
        hh = max(1, prev.shape[0] // 2)
        ww = max(1, prev.shape[1] // 2)
        ys = np.minimum(2 * np.arange(hh), prev.shape[0] - 1)
        ys1 = np.minimum(2 * np.arange(hh) + 1, prev.shape[0] - 1)
        xs = np.minimum(2 * np.arange(ww), prev.shape[1] - 1)
        xs1 = np.minimum(2 * np.arange(ww) + 1, prev.shape[1] - 1)
        lvl = 0.25 * (prev[ys][:, xs] + prev[ys1][:, xs]
                      + prev[ys][:, xs1] + prev[ys1][:, xs1])
        levels.append(lvl.astype(np.float32))
    return levels


@dataclasses.dataclass
class TexturePool:
    """The packed pool, tensors on one device (the reference's leaves)."""

    data: torch.Tensor  # (total, 3) f32
    level_offset: torch.Tensor  # (T, MAX_LEVELS) i32
    level_w: torch.Tensor  # (T, MAX_LEVELS) i32
    level_h: torch.Tensor  # (T, MAX_LEVELS) i32
    n_levels: torch.Tensor  # (T,) i32
    wrap: torch.Tensor  # (T,) i32

    def to(self, device) -> "TexturePool":
        return TexturePool(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


class TexturePoolBuilder:
    def __init__(self) -> None:
        self.chunks: list[np.ndarray] = []
        self.offsets: list[list[int]] = []
        self.widths: list[list[int]] = []
        self.heights: list[list[int]] = []
        self.wraps: list[int] = []
        self.total = 0

    def add(self, image: np.ndarray, wrap: int = WRAP_REPEAT) -> int:
        levels = build_pyramid(image, wrap)
        offs, ws, hs = [], [], []
        for lvl in levels[:MAX_LEVELS]:
            offs.append(self.total)
            hs.append(lvl.shape[0])
            ws.append(lvl.shape[1])
            self.chunks.append(lvl.reshape(-1, 3))
            self.total += lvl.shape[0] * lvl.shape[1]
        # padded to MAX_LEVELS here, before build() counts the levels:
        # the reference's quirk, kept (module docstring)
        pad = MAX_LEVELS - len(offs)
        self.offsets.append(offs + [offs[-1]] * pad)
        self.widths.append(ws + [ws[-1]] * pad)
        self.heights.append(hs + [hs[-1]] * pad)
        self.wraps.append(wrap)
        return len(self.wraps) - 1

    def build(self, device="cuda") -> TexturePool:
        if not self.chunks:
            leaves = dict(
                data=np.zeros((1, 3), np.float32),
                level_offset=np.zeros((1, MAX_LEVELS), np.int32),
                level_w=np.ones((1, MAX_LEVELS), np.int32),
                level_h=np.ones((1, MAX_LEVELS), np.int32),
                n_levels=np.ones((1,), np.int32),
                wrap=np.zeros((1,), np.int32))
        else:
            leaves = dict(
                data=np.concatenate(self.chunks),
                level_offset=np.asarray(self.offsets, np.int32),
                level_w=np.asarray(self.widths, np.int32),
                level_h=np.asarray(self.heights, np.int32),
                n_levels=np.asarray([min(len(o), MAX_LEVELS)
                                     for o in self.offsets], np.int32),
                wrap=np.asarray(self.wraps, np.int32))
        return TexturePool(**{k: torch.as_tensor(v, device=device)
                              for k, v in leaves.items()})


def _texel(pool: TexturePool, tex, level, s, t):
    """Wrapped texel fetch; tex / level / s / t all (N,) int tensors."""
    w = pool.level_w[tex, level]
    h = pool.level_h[tex, level]
    wrap = pool.wrap[tex]
    # floor-mod, as jnp.mod on int32 (torch.fmod truncates)
    s_rep = torch.remainder(s, w)
    t_rep = torch.remainder(t, h)
    s_cl = torch.minimum(torch.clamp_min(s, 0), w - 1)
    t_cl = torch.minimum(torch.clamp_min(t, 0), h - 1)
    outside = (s < 0) | (s >= w) | (t < 0) | (t >= h)
    # REPEAT wraps; CLAMP and BLACK both clamp, BLACK then zeroes outside
    repeat = wrap == WRAP_REPEAT
    si = torch.where(repeat, s_rep, s_cl)
    ti = torch.where(repeat, t_rep, t_cl)
    val = pool.data[(pool.level_offset[tex, level] + ti * w + si).long()]
    black = (wrap == WRAP_BLACK) & outside
    return torch.where(black[..., None], 0.0, val)


def _triangle(pool: TexturePool, tex, level, st):
    """Bilinear lookup at one mip level, clipped to the texture's levels."""
    level = torch.minimum(torch.clamp_min(level, 0), pool.n_levels[tex] - 1)
    w = pool.level_w[tex, level].to(torch.float32)
    h = pool.level_h[tex, level].to(torch.float32)
    s = st[..., 0] * w - 0.5
    t = st[..., 1] * h - 0.5
    s0 = torch.floor(s)
    t0 = torch.floor(t)
    ds = (s - s0)[..., None]
    dt = (t - t0)[..., None]
    s0 = s0.to(torch.int32)
    t0 = t0.to(torch.int32)
    return (_texel(pool, tex, level, s0, t0) * (1 - ds) * (1 - dt)
            + _texel(pool, tex, level, s0, t0 + 1) * (1 - ds) * dt
            + _texel(pool, tex, level, s0 + 1, t0) * ds * (1 - dt)
            + _texel(pool, tex, level, s0 + 1, t0 + 1) * ds * dt)


def lookup_width(pool: TexturePool, tex, st, width):
    """Trilinear mip lookup.

    tex: (N,) int texture ids; st: (N, 2); width: (N,) tensor or a Python
    number. A Python 0 takes level 0 bilinearly (the rays of every bounce
    past the camera's carry no differentials); any tensor, all zeros
    included, takes the trilinear path at level n_levels - 1 +
    log2(max(width, 1e-8)), as the reference does (the two round
    differently).
    """
    tex = tex.long()
    if isinstance(width, (int, float)) and float(width) == 0.0:
        zero = torch.zeros(st.shape[:-1], dtype=torch.long,
                           device=st.device)
        return _triangle(pool, tex, zero, st)
    n_lev = pool.n_levels[tex].to(torch.float32)
    width = torch.as_tensor(width, dtype=torch.float32,
                            device=st.device).expand(st.shape[:-1])
    level = n_lev - 1.0 + torch.log2(torch.clamp_min(width, 1e-8))
    lo = torch.floor(torch.minimum(torch.clamp_min(level, 0.0),
                                   n_lev - 1.0)).to(torch.long)
    delta = torch.clamp(level - lo.to(torch.float32), 0.0, 1.0)[..., None]
    v0 = _triangle(pool, tex, lo, st)
    v1 = _triangle(pool, tex, lo + 1, st)
    return v0 * (1 - delta) + v1 * delta


def pack_descriptors(kind, uv, rgb0, rgb1, scale, image, channel, srgb,
                     pool: TexturePool):
    """The texture kernels' (K3, K4) descriptor tables from the txd_*
    leaves and the pool, on the pool's device: (D, TXF_WIDTH) f32 rows
    (UV map, rgb0, rgb1, scale) and (D, TXI_WIDTH) i32 rows (kind, sRGB
    flag, channel, and for an image descriptor its texture's level count,
    wrap mode and level tables; zeros for the other kinds). One row read
    a lane replaces the descriptor-then-texture gathers of the plain
    lookup."""
    d = kind.shape[0]
    dev = pool.data.device
    f32 = torch.zeros((d, TXF_WIDTH), dtype=torch.float32, device=dev)
    f32[:, TXF_UV:TXF_UV + 4] = uv
    f32[:, TXF_RGB0:TXF_RGB0 + 3] = rgb0
    f32[:, TXF_RGB1:TXF_RGB1 + 3] = rgb1
    f32[:, TXF_SCALE:TXF_SCALE + 3] = scale
    i32 = torch.zeros((d, TXI_WIDTH), dtype=torch.int32, device=dev)
    i32[:, TXI_KIND] = kind
    i32[:, TXI_SRGB] = srgb.to(torch.int32)
    i32[:, TXI_CHANNEL] = channel
    img = kind == 2
    tex = image[img].long()
    i32[img, TXI_NLEVELS] = pool.n_levels[tex]
    i32[img, TXI_WRAP] = pool.wrap[tex]
    i32[img, TXI_OFFSET:TXI_W] = pool.level_offset[tex]
    i32[img, TXI_W:TXI_H] = pool.level_w[tex]
    i32[img, TXI_H:TXI_WIDTH] = pool.level_h[tex]
    return f32, i32
