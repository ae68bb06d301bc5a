"""The 2-D sampler's in-place row search (``core/sampling.py``).

``searchsorted_rows`` searches each lane's row of the flat conditional
CDF table where it lies, a cell a step, in place of copying the row per
lane. It must give exactly what ``searchsorted_batched`` gives on the
copied rows (which ``tests/test_torch_lights.py`` holds to the JAX
package's ``jax_searchsorted_batched``): the 'right' rule, the count of
entries <= u less one, ties included.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.core import sampling as psm

ONE_MINUS_ULP = np.nextafter(np.float32(1.0), np.float32(0.0))


def _tables(nu: int, seed: int):
    """Conditional CDF rows of a (6, nu) function with a random row, a
    row of zero-weight runs, an all-zero row (the uniform cdf), a row of
    one nonzero cell, and two more random rows."""
    rng = np.random.default_rng(seed)
    func = rng.uniform(0, 1, (6, nu)).astype(np.float32)
    func[1, : nu // 3] = 0.0
    func[1, nu // 2: nu // 2 + max(1, nu // 4)] = 0.0
    func[2] = 0.0
    func[3] = 0.0
    func[3, nu // 2] = 2.0
    return psm._build_1d(func)[1]


def _uniforms(cdf, rng, n=4096):
    """Random u, u = 0 and 1 - ulp, every cdf entry and its two float
    neighbours, with a random row for each."""
    entries = np.unique(cdf)
    u = np.concatenate([
        rng.uniform(0, 1, n).astype(np.float32), [0.0, ONE_MINUS_ULP],
        entries, np.nextafter(entries, np.float32(-1.0)),
        np.nextafter(entries, np.float32(2.0))]).astype(np.float32)
    u = np.clip(u, 0.0, ONE_MINUS_ULP)
    return u, rng.integers(0, cdf.shape[0], u.shape[0])


@pytest.mark.parametrize("nu", [1, 2, 3, 7, 8, 20, 2048])
def test_row_search_equals_searchsorted_on_copied_rows(nu):
    cdf = _tables(nu, seed=nu)
    rng = np.random.default_rng(100 + nu)
    u, v = _uniforms(cdf, rng)
    cdf_t, u_t = torch.as_tensor(cdf), torch.as_tensor(u)
    v_t = torch.as_tensor(v, dtype=torch.int64)
    want = psm.searchsorted_batched(cdf_t[v_t], u_t)
    got = psm.searchsorted_rows(cdf_t.reshape(-1), v_t * (nu + 1), nu + 1,
                                u_t)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    # both ends of the range: u = 0 counts the leading zeros, 1 - ulp all
    # but the last entry (1)
    ends = psm.searchsorted_rows(
        cdf_t.reshape(-1), torch.arange(6) * (nu + 1), nu + 1,
        torch.full((6,), float(ONE_MINUS_ULP)))
    assert torch.equal(ends, torch.as_tensor(
        (cdf <= ONE_MINUS_ULP).sum(axis=1) - 1))


def _sample_2d_copied_rows(d, u):
    """The 2-D sample with the search on copied rows (``cond_cdf[v]``,
    one (nu + 1) row a lane), as the sampler did before."""
    d1, pdf1, v = psm.sample_distribution_1d(d.marg_func, d.marg_cdf,
                                             d.marg_int, u[..., 1])
    nu = d.cond_func.shape[-1]
    u0 = u[..., 0]
    off = torch.clamp(psm.searchsorted_batched(d.cond_cdf[v], u0), 0, nu - 1)
    c0, c1 = d.cond_cdf[v, off], d.cond_cdf[v, off + 1]
    denom = c1 - c0
    du = torch.where(denom > 0.0,
                     (u0 - c0) / torch.where(denom > 0.0, denom, 1.0),
                     u0 - c0)
    int_v = d.cond_int[v]
    pdf0 = torch.where(int_v > 0.0, d.cond_func[v, off]
                       / torch.clamp_min(int_v, 1e-30), 0.0)
    return torch.stack([(off.to(torch.float32) + du) / nu, d1], -1), \
        pdf0 * pdf1


def test_sample_2d_searches_the_flat_table(monkeypatch):
    """The 2-D sampler searches the flat table (one search, on a 1-D
    tensor) and samples exactly as the copied-row search does."""
    dims = []
    real = psm.searchsorted_rows

    def spy(flat, base, n, u):
        dims.append(flat.dim())
        return real(flat, base, n, u)
    monkeypatch.setattr(psm, "searchsorted_rows", spy)
    rng = np.random.default_rng(7)
    func = rng.uniform(0, 1, (16, 64)).astype(np.float32)
    func[4] = 0.0
    func[9, 10:40] = 0.0
    d = psm.Distribution2D.build(func, device="cpu")
    u = torch.as_tensor(rng.uniform(0, 1, (4096, 2)).astype(np.float32))
    uv, pdf = d.sample(u)
    assert dims == [1]
    want_uv, want_pdf = _sample_2d_copied_rows(d, u)
    assert torch.equal(uv, want_uv) and torch.equal(pdf, want_pdf)
