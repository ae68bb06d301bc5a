"""Film: additive (contrib*w, sum w) accumulator with a dense tile splat.

Port of ``pathtracer_tpu/core/film.py``. The padded accumulator is
channel-first (4, H+pad, W+pad); every band's tile is added into it in
place, and the tile itself is built by in-place shifted adds, so no
per-sample scatter and no full-film temporaries are made. The unpadded
film (``film_new``) takes scattered samples (``add_samples``).
"""

from __future__ import annotations

import numpy as np
import torch

from .filter import FILTER_TABLE_WIDTH
from .math import gamma_correct

FILM_PAD = 4  # padded border: filter radius 2 (sample bounds) + 2 (splat)


def film_new(width: int, height: int, device="cuda") -> torch.Tensor:
    """Zeroed (H, W, 4) film: (r*w, g*w, b*w, sum w) a pixel."""
    return torch.zeros((height, width, 4), dtype=torch.float32,
                       device=device)


def add_samples(film, p_film, radiance, filter_table, radius: float = 2.0,
                footprint: int = 5):
    """Splat a batch of samples into the film (in place; returns it).

    film: (H, W, 4); p_film: (N, 2) raster positions; radiance: (N, 3);
    filter_table: (16, 16) host table (``make_filter``). A sample at
    discrete position pd = p_film - 0.5 reaches the pixels x in
    [ceil(pd - r), floor(pd + r)], each weighted by the table entry
    floor(|x - pd| / r * 16) (clamped to 15) of each axis. Off-film
    targets are dropped (weight 0 at a clamped index).
    """
    h, w, _ = film.shape
    dev = film.device
    pd = p_film - 0.5
    p0 = torch.ceil(pd - radius).to(torch.int64)  # inclusive lo
    p1 = (torch.floor(pd + radius) + 1.0).to(torch.int64)  # exclusive hi
    offs = torch.arange(footprint, device=dev)
    xs = p0[:, 0:1] + offs[None, :]  # (N, footprint)
    ys = p0[:, 1:2] + offs[None, :]
    inv_r = 1.0 / radius

    def table_index(c, pdc):
        f = torch.abs((c.to(torch.float32) - pdc) * inv_r
                      * FILTER_TABLE_WIDTH)
        return torch.clamp_max(torch.floor(f).to(torch.int64),
                               FILTER_TABLE_WIDTH - 1)

    ifx = table_index(xs, pd[:, 0:1])
    ify = table_index(ys, pd[:, 1:2])
    valid_x = (xs < p1[:, 0:1]) & (xs >= 0) & (xs < w)
    valid_y = (ys < p1[:, 1:2]) & (ys >= 0) & (ys < h)
    table = torch.as_tensor(np.asarray(filter_table, np.float32),
                            device=dev).reshape(-1)
    wgt = table[ify[:, :, None] * FILTER_TABLE_WIDTH + ifx[:, None, :]]
    wgt = wgt * (valid_y[:, :, None] & valid_x[:, None, :]).to(torch.float32)
    update = torch.cat([radiance[:, None, None, :] * wgt[..., None],
                        wgt[..., None]], dim=-1)  # (N, Fy, Fx, 4)
    flat = (torch.clamp(ys, 0, h - 1)[:, :, None] * w
            + torch.clamp(xs, 0, w - 1)[:, None, :]).reshape(-1)
    film.view(h * w, 4).index_put_((flat,), update.reshape(-1, 4),
                                   accumulate=True)
    return film


def sample_bounds(width: int, height: int, radius: float = 2.0):
    """Raster-space sample rectangle, expanded by the filter radius:
    p_min = floor(0.5 - r), p_max = ceil(res - 0.5 + r)."""
    p_min = int(np.floor(0.5 - radius))
    p_max_x = int(np.ceil(width - 0.5 + radius))
    p_max_y = int(np.ceil(height - 0.5 + radius))
    return (p_min, p_min), (p_max_x, p_max_y)


def film_pad_new(width: int, height: int, extra_rows: int = 0,
                 device="cuda") -> torch.Tensor:
    """Zeroed padded accumulator (4, H+2*FILM_PAD+extra_rows, W+2*FILM_PAD).

    ``extra_rows`` leaves room for the last row band's zero-weight rows.
    """
    return torch.zeros((4, height + 2 * FILM_PAD + extra_rows,
                        width + 2 * FILM_PAD), dtype=torch.float32,
                       device=device)


def film_crop(film_pad: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(4, Hp, Wp) padded accumulator -> (H, W, 4) public film layout."""
    return film_pad[:, FILM_PAD:FILM_PAD + height,
                    FILM_PAD:FILM_PAD + width].permute(1, 2, 0).contiguous()


def splat_halfwidth(radius: float) -> int:
    """Integer half-width of the splat footprint for a filter radius."""
    return int(np.floor(radius + 0.5))


def splat_tile(radiance, jx, jy, valid, filter_f1d, radius: float = 2.0):
    """Dense tile splat: one sample per pixel of a (Th, Tw) band.

    radiance: (Th, Tw, 3); jx, jy: (Th, Tw) jitters in [0,1); valid:
    (Th, Tw) bool; filter_f1d: host (16,) separable filter row. Returns a
    (4, Th+2h, Tw+2h) channel-first tile, h = splat_halfwidth(radius).
    The (2h+1)^2 shifted contributions are added into the tile in place,
    in the reference's order, so every pixel sums the same terms in the
    same order.
    """
    th, tw = radiance.shape[:2]
    half = splat_halfwidth(radius)
    pad = 2 * half
    fp = 2 * half + 1
    tile = torch.zeros((4, th + pad, tw + pad), dtype=torch.float32,
                       device=radiance.device)
    inv_r = 1.0 / radius
    f1d = torch.as_tensor(np.asarray(filter_f1d, np.float32),
                          device=radiance.device)

    def axis_weights(j, d):
        off = d - j + 0.5
        fi = torch.clamp_max(
            torch.floor(torch.abs(off) * inv_r * FILTER_TABLE_WIDTH)
            .to(torch.int64), FILTER_TABLE_WIDTH - 1)
        return torch.where(torch.abs(off) <= radius, f1d[fi], 0.0)

    wx = [axis_weights(jx, dx) for dx in range(-half, half + 1)]
    wy = [axis_weights(jy, dy) for dy in range(-half, half + 1)]

    l_ok = torch.where(valid[None], radiance.permute(2, 0, 1), 0.0)
    vmask = valid.to(torch.float32)
    for iy in range(fp):
        for ix in range(fp):
            w = wy[iy] * wx[ix] * vmask  # (Th, Tw)
            dst = tile[:, iy:iy + th, ix:ix + tw]  # in-place view add
            dst[:3] += l_ok * w[None]
            dst[3] += w
    return tile


def film_pad_accumulate(film_pad, tile, band_x0: int, band_y0: int,
                        half: int = 2):
    """Add a (4, Th+2*half, Tw+2*half) band tile into the padded film,
    IN PLACE (the film is the render's only full-size buffer); returns it.
    """
    y = band_y0 - half + FILM_PAD
    x = band_x0 - half + FILM_PAD
    th, tw = tile.shape[1], tile.shape[2]
    film_pad[:, y:y + th, x:x + tw] += tile
    return film_pad


def to_rgb(film):
    """Normalize the accumulator to linear RGB (H, W, 3)."""
    return film[..., :3] * (1.0 / torch.clamp_min(film[..., 3:4], 1e-20))


def to_rgb8(film) -> np.ndarray:
    """sRGB 8-bit image as numpy (H, W, 3)."""
    srgb = torch.clamp(gamma_correct(to_rgb(film)) * 255.0 + 0.5, 0.0, 255.0)
    return srgb.cpu().numpy().astype(np.uint8)
