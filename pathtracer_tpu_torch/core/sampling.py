"""Sampling warps and piecewise-constant distributions.

Port of ``pathtracer_tpu/core/sampling.py``: the hemisphere, sphere, disk
and triangle warps, and Distribution1D / Distribution2D as cdf tables
built on the host and sampled with ``torch.searchsorted`` (the same
'right' ties as the reference's counting form).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .math import sqrt


def concentric_sample_disk(u):
    """(..., 2) -> (..., 2) points in the unit disk."""
    u_off = 2.0 * u - 1.0
    x, y = u_off[..., 0], u_off[..., 1]
    zero = (x == 0.0) & (y == 0.0)
    x_major = torch.abs(x) > torch.abs(y)
    # guard divisions; the selected branch always has a nonzero denominator
    safe_x = torch.where(x == 0.0, 1.0, x)
    safe_y = torch.where(y == 0.0, 1.0, y)
    r = torch.where(x_major, x, y)
    theta = torch.where(x_major, (np.pi / 4.0) * (y / safe_x),
                        (np.pi / 2.0) - (np.pi / 4.0) * (x / safe_y))
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                   dim=-1)
    return torch.where(zero[..., None], 0.0, p)


def cosine_sample_hemisphere(u):
    """(..., 2) -> (..., 3), pdf = cos(theta)/pi."""
    d = concentric_sample_disk(u)
    dx, dy = d[..., 0], d[..., 1]
    z = sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    return torch.stack([dx, dy, z], dim=-1)


def uniform_sample_triangle(u):
    """(..., 2) -> barycentric (b0, b1)."""
    su0 = sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def uniform_sample_hemisphere(u):
    """(..., 2) -> (..., 3) unit vectors, z >= 0."""
    z = u[..., 0]
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * np.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_hemisphere_pdf():
    return np.float32(0.5 / np.pi)


def uniform_sample_sphere(u):
    """(..., 2) -> (..., 3) unit vectors over the full sphere, pdf 1/(4 pi)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * np.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sphere_pdf():
    return np.float32(0.25 / np.pi)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * np.float32(1.0 / np.pi)


def _build_1d(f: np.ndarray):
    """Host tables of a (batched) piecewise-constant distribution over the
    last axis: (func, cdf (..., n+1), func_int (...)). A row whose
    integral is 0 gets the uniform cdf."""
    f = np.asarray(f, np.float32)
    n = f.shape[-1]
    cdf = np.concatenate(
        [np.zeros(f.shape[:-1] + (1,), np.float32), np.cumsum(f / n, axis=-1)],
        axis=-1).astype(np.float32)
    func_int = cdf[..., -1].copy()
    uniform = np.arange(n + 1, dtype=np.float32) / n
    zero = func_int == 0.0
    safe = np.where(zero, 1.0, func_int)
    cdf = np.where(zero[..., None], uniform, cdf / safe[..., None])
    return f, cdf, func_int


@dataclasses.dataclass
class Distribution1D:
    """Piecewise-constant 1D distribution: func (n,), cdf (n+1,) and the
    0-d func_int, as tensors. Built on the host, as the reference does."""

    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @staticmethod
    def build(f: np.ndarray, device="cuda") -> "Distribution1D":
        return Distribution1D(*(torch.as_tensor(np.asarray(a), device=device)
                                for a in _build_1d(f)))


def sample_distribution_1d(func, cdf, func_int, u):
    """Continuous sample of a 1D distribution. func (n,), cdf (n+1,),
    u (...,). Returns (x in [0,1), pdf, offset)."""
    n = func.shape[-1]
    offset = torch.clamp(
        torch.searchsorted(cdf, u.contiguous(), right=True) - 1, 0, n - 1)
    c0 = cdf[offset]
    c1 = cdf[offset + 1]
    denom = c1 - c0
    du = torch.where(denom > 0.0,
                     (u - c0) / torch.where(denom > 0.0, denom, 1.0), u - c0)
    pdf = torch.where(func_int > 0.0,
                      func[offset] / torch.clamp_min(func_int, 1e-30), 0.0)
    return (offset.to(torch.float32) + du) / n, pdf, offset


def searchsorted_batched(cdf_rows, u):
    """Row-wise 'right' searchsorted minus one: cdf_rows (..., n+1) sorted
    rows, u (...,). The count of entries <= u, less one, as the
    reference's ``jax_searchsorted_batched`` counts it."""
    return torch.searchsorted(cdf_rows.contiguous(), u[..., None].contiguous(),
                              right=True)[..., 0] - 1


def searchsorted_rows(flat, base, n: int, u):
    """``searchsorted_batched`` over rows of a flat table, read in place:
    the count of entries <= u, less one, in the sorted row
    ``flat[base : base + n]`` of each lane (base, u (...,)). A binary
    search of ``n.bit_length()`` steps (ceil(log2(n + 1))), each reading
    one entry a lane, so no lane copies its row."""
    pos = torch.zeros_like(base)
    for k in reversed(range(n.bit_length())):
        cand = pos + (1 << k)
        inside = cand <= n
        val = flat[base + torch.where(inside, cand, n) - 1]
        pos = torch.where(inside & (val <= u), cand, pos)
    return pos - 1


@dataclasses.dataclass
class Distribution2D:
    """2D distribution: per-row conditionals and the marginal over rows.

    cond_func (nv, nu), cond_cdf (nv, nu+1), cond_int (nv,), marg_func
    (nv,), marg_cdf (nv+1,), marg_int (), as tensors.
    """

    cond_func: torch.Tensor
    cond_cdf: torch.Tensor
    cond_int: torch.Tensor
    marg_func: torch.Tensor
    marg_cdf: torch.Tensor
    marg_int: torch.Tensor

    @staticmethod
    def build_host(func: np.ndarray) -> dict:
        """The six tables as host numpy arrays, by field name."""
        cond = _build_1d(np.asarray(func, np.float32))
        marg = _build_1d(cond[2])
        return dict(cond_func=cond[0], cond_cdf=cond[1], cond_int=cond[2],
                    marg_func=marg[0], marg_cdf=marg[1], marg_int=marg[2])

    @staticmethod
    def build(func: np.ndarray, device="cuda") -> "Distribution2D":
        return Distribution2D(**{
            k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in Distribution2D.build_host(func).items()})

    def sample(self, u):
        """u (..., 2) -> (uv (..., 2), pdf (...,))."""
        return sample_distribution_2d(
            self.cond_func, self.cond_cdf, self.cond_int, self.marg_func,
            self.marg_cdf, self.marg_int, u)

    def pdf(self, p):
        """Density at uv p (..., 2)."""
        return pdf_distribution_2d(self.cond_func, self.marg_int, p)


def pdf_distribution_2d(cond_func, marg_int, p):
    """Density of the 2D tables at uv p (..., 2): the table cell's value
    over the whole integral."""
    nv, nu = cond_func.shape
    iu = torch.clamp((p[..., 0] * nu).to(torch.int64), 0, nu - 1)
    iv = torch.clamp((p[..., 1] * nv).to(torch.int64), 0, nv - 1)
    return cond_func[iv, iu] / torch.clamp_min(marg_int, 1e-30)


def sample_distribution_2d(cond_func, cond_cdf, cond_int, marg_func,
                           marg_cdf, marg_int, u):
    """Sample the 2D tables at u (..., 2): v from the marginal by u[..., 1],
    then u from row v's conditional by u[..., 0]. Returns (uv, pdf)."""
    d1, pdf1, v = sample_distribution_1d(marg_func, marg_cdf, marg_int,
                                         u[..., 1])
    nu = cond_func.shape[-1]
    int_v = cond_int[v]
    u0 = u[..., 0]
    # the search reads row v of the flat table in place, a cell a step
    off = torch.clamp(searchsorted_rows(cond_cdf.reshape(-1), v * (nu + 1),
                                        nu + 1, u0), 0, nu - 1)
    c0 = cond_cdf[v, off]
    c1 = cond_cdf[v, off + 1]
    denom = c1 - c0
    du = torch.where(denom > 0.0,
                     (u0 - c0) / torch.where(denom > 0.0, denom, 1.0),
                     u0 - c0)
    f = cond_func[v, off]
    pdf0 = torch.where(int_v > 0.0, f / torch.clamp_min(int_v, 1e-30), 0.0)
    d0 = (off.to(torch.float32) + du) / nu
    return torch.stack([d0, d1], dim=-1), pdf0 * pdf1
