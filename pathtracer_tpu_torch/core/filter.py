"""Reconstruction filters and the 16x16 precomputed filter table.

Parity with reference ``src/common/filter.rs`` (Gaussian alpha=2 radius=2
default, Triangle radius=1) and the table bake in ``src/common/film.rs:131-144``.
"""

from __future__ import annotations

import numpy as np

FILTER_TABLE_WIDTH = 16


def gaussian_filter_table(alpha: float = 2.0, radius: float = 2.0) -> np.ndarray:
    """(16,16) table of filter weights over the positive quadrant.

    Entry [y, x] = f((x+0.5)*r/16) * f((y+0.5)*r/16) with
    f(d) = max(0, exp(-alpha d^2) - exp(-alpha r^2)).
    """
    expv = np.exp(-alpha * radius * radius)
    d = (np.arange(FILTER_TABLE_WIDTH, dtype=np.float32) + 0.5) * radius / FILTER_TABLE_WIDTH
    f = np.maximum(0.0, np.exp(-alpha * d * d) - expv).astype(np.float32)
    return np.outer(f, f).astype(np.float32)


def triangle_filter_table(radius: float = 1.0) -> np.ndarray:
    d = (np.arange(FILTER_TABLE_WIDTH, dtype=np.float32) + 0.5) * radius / FILTER_TABLE_WIDTH
    f = np.maximum(0.0, radius - np.abs(d)).astype(np.float32)
    return np.outer(f, f).astype(np.float32)


def lanczos_sinc_filter_table(radius: float = 2.0,
                              tau: float = 3.0) -> np.ndarray:
    """Windowed-sinc table. The reference DECLARES LanczosSincFilter but
    left evaluate() as todo!() (filter.rs:17-36); this implements the
    PBRT windowed sinc it stubs: f(x) = sinc(x) * sinc(x / tau) for
    |x| < radius. The default radius stays 2 so the film's fixed
    border padding (film.FILM_PAD) covers the splat footprint."""
    f, _ = filter_f1d("lanczos", radius, tau=tau)
    return np.outer(f, f).astype(np.float32)


def _sinc(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1e-5, 1.0, np.sin(np.pi * x) / (np.pi * x + 1e-20))


def filter_f1d(kind: str = "gaussian", radius: float | None = None,
               tau: float = 3.0):
    """(16,) separable 1-D filter row; the 2-D table is its outer product."""
    if kind == "lanczos":
        r = 2.0 if radius is None else radius
        assert r <= 2.0, "film border padding (FILM_PAD) covers radius <= 2"
        d = (np.arange(FILTER_TABLE_WIDTH, dtype=np.float32) + 0.5) * r \
            / FILTER_TABLE_WIDTH
        lanczos = _sinc(d / tau)
        return (_sinc(d) * lanczos).astype(np.float32), r
    if kind == "gaussian":
        r = 2.0 if radius is None else radius
        alpha = 2.0
        expv = np.exp(-alpha * r * r)
        d = (np.arange(FILTER_TABLE_WIDTH, dtype=np.float32) + 0.5) * r \
            / FILTER_TABLE_WIDTH
        return np.maximum(0.0, np.exp(-alpha * d * d) - expv) \
            .astype(np.float32), r
    if kind == "triangle":
        r = 1.0 if radius is None else radius
        d = (np.arange(FILTER_TABLE_WIDTH, dtype=np.float32) + 0.5) * r \
            / FILTER_TABLE_WIDTH
        return np.maximum(0.0, r - np.abs(d)).astype(np.float32), r
    raise ValueError(f"unknown filter kind: {kind}")


def make_filter(kind: str = "gaussian", radius: float | None = None):
    """Returns (table (16,16) float32, radius float)."""
    if kind == "gaussian":
        r = 2.0 if radius is None else radius
        return gaussian_filter_table(2.0, r), r
    if kind == "triangle":
        r = 1.0 if radius is None else radius
        return triangle_filter_table(r), r
    if kind == "lanczos":
        r = 2.0 if radius is None else radius
        return lanczos_sinc_filter_table(r), r
    raise ValueError(f"unknown filter kind: {kind}")
