"""The port's Sobol sampler must give the JAX package's bits exactly.

The port carries u32 words as int64 (PyTorch has no uint32 shifts on the
CPU); every value here is compared as a 32-bit word and as the float
sample it becomes. Mirrors tests/test_sobol.py's domains.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.ops import sobol as jsb
from pathtracer_tpu_torch.ops import sobol as psb

torch.set_num_threads(1)

DOMAINS = [((-2, -2), (258, 258), 4), ((0, 0), (64, 64), 16),
           ((-2, -2), (644, 484), 16)]


def _pixels(domain_args, n=96, seed=0):
    (x0, y0), (x1, y1), _ = domain_args
    rng = np.random.default_rng(seed)
    return rng.integers(x0, x1, n), rng.integers(y0, y1, n)


@pytest.mark.parametrize("dom_args", DOMAINS)
def test_domain_and_statics_match(dom_args):
    jdom = jsb.SobolDomain.create(*dom_args)
    pdom = psb.SobolDomain.create(*dom_args)
    assert (pdom.p_min, pdom.resolution, pdom.m, pdom.spp) == \
        (jdom.p_min, jdom.resolution, jdom.m, jdom.spp)
    px, py = _pixels(dom_args)
    for got, want in zip(psb.pixel_statics(pdom, px, py),
                         jsb.pixel_statics(jdom, px, py)):
        np.testing.assert_array_equal(got, want)
    for frame in (0, 1, 5, 15, 63):
        assert psb.frame_statics(pdom, frame) == \
            jsb.frame_statics(jdom, frame)
    jlo, jhi = jsb.vdc_inv_rows(jdom)
    plo, phi = psb.vdc_inv_rows(pdom, "cpu")
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("dom_args", DOMAINS)
def test_index_and_samples_bit_exact(dom_args):
    jdom = jsb.SobolDomain.create(*dom_args)
    pdom = psb.SobolDomain.create(*dom_args)
    px, py = _pixels(dom_args, seed=1)
    scramble, b_base = jsb.pixel_statics(jdom, px, py)
    jinv = jsb.vdc_inv_rows(jdom)
    pinv = psb.vdc_inv_rows(pdom, "cpu")
    sm = jsb.sm32_device()
    psm = psb.sm32_device("cpu")
    pscr = torch.as_tensor(scramble.astype(np.int64))
    for frame in (0, 3, 12):
        lo_s, hi_s, delta = jsb.frame_statics(jdom, frame)
        jlo, jhi = jsb.sobol_index(jnp.asarray(b_base), jnp.uint32(delta),
                                   jnp.uint32(lo_s), jnp.uint32(hi_s), *jinv)
        plo, phi = psb.sobol_index(torch.as_tensor(b_base.astype(np.int64)),
                                   int(delta), int(lo_s), int(hi_s), *pinv)
        np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(phi.numpy(), np.asarray(jhi))
        for dim in (0, 2, 9, 41, 1022):
            want = jsb.sobol_sample_dim(jlo, jhi, dim, jnp.asarray(scramble),
                                        sm)
            got = psb.sobol_sample_dim(plo, phi, dim, pscr, psm)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            want2 = jsb.sobol_sample_dim2(jlo, jhi, dim,
                                          jnp.asarray(scramble), sm)
            got2 = psb.sobol_sample_dim2(plo, phi, dim, pscr, psm)
            np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


def test_samples_bit_exact_on_high_index_bits():
    """Random 52-bit indices exercise every row of the generator matrix,
    including the hi word's 20 bits."""
    rng = np.random.default_rng(2)
    n = 256
    idx = rng.integers(0, 1 << 52, n, dtype=np.uint64)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    scr = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    sm = jsb.sm32_device()
    psm = psb.sm32_device("cpu")
    args = [torch.as_tensor(a.astype(np.int64)) for a in (lo, hi)]
    for dim in (0, 7, 500, 1023):
        want = jsb.sobol_sample_dim(jnp.asarray(lo), jnp.asarray(hi), dim,
                                    jnp.asarray(scr), sm)
        got = psb.sobol_sample_dim(*args, dim,
                                   torch.as_tensor(scr.astype(np.int64)), psm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dim", [1021, 1022, 1023, 1024, 1030])
def test_dims_past_the_table_clamp_as_jax(dim):
    """A dimension past the table's 1,024 rows reads as the reference's
    ``dynamic_slice`` does: the 1-D row at min(dim, 1023), the pair's
    start at min(dim, 1022)."""
    rng = np.random.default_rng(3)
    n = 64
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 20, n, dtype=np.uint64).astype(np.uint32)
    scr = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    sm = jsb.sm32_device()
    psm = psb.sm32_device("cpu")
    jargs = (jnp.asarray(lo), jnp.asarray(hi), dim, jnp.asarray(scr), sm)
    pargs = (torch.as_tensor(lo.astype(np.int64)),
             torch.as_tensor(hi.astype(np.int64)), dim,
             torch.as_tensor(scr.astype(np.int64)), psm)
    got = psb.sobol_sample_dim(*pargs)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsb.sobol_sample_dim(*jargs)))
    got2 = psb.sobol_sample_dim2(*pargs)
    assert got2.shape == (n, 2)
    np.testing.assert_array_equal(got2.numpy(),
                                  np.asarray(jsb.sobol_sample_dim2(*jargs)))


def test_render_past_the_table_runs():
    """At max_depth 130 the bounce slots (2 + 8 * bounce) pass the table's
    last dimension; a 4x4, 1-spp render finishes with a finite film."""
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
    cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=(4, 4),
                              device="cpu")
    film = PathIntegrator(PathConfig(max_depth=130), spp=1).render(cam, sd)
    assert torch.isfinite(film).all() and (film[..., 3] > 0).all()


@pytest.mark.parametrize("frame", range(64))
def test_index_takes_frame_words_as_tensors(frame):
    """The frame's words as 0-d int64 tensors (what a captured CUDA graph
    reads from its buffers) give the bits of the host ints, over every
    frame of a 64-spp render at 640x480."""
    dom = psb.SobolDomain.create((-2, -2), (644, 484), 64)
    px, py = _pixels(((-2, -2), (644, 484), 64), n=512, seed=frame)
    _, b_base = psb.pixel_statics(dom, px, py)
    b_base = torch.as_tensor(b_base.astype(np.int64))
    inv = psb.vdc_inv_rows(dom, "cpu")
    lo_s, hi_s, delta = psb.frame_statics(dom, frame)
    want = psb.sobol_index(b_base, int(delta), int(lo_s), int(hi_s), *inv)
    got = psb.sobol_index(b_base, *(torch.tensor(int(w), dtype=torch.int64)
                                    for w in (delta, lo_s, hi_s)), *inv)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and torch.equal(g, w)
