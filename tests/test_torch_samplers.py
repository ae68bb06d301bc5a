"""The stratified and random samplers: the port's bits against the JAX
package's, the reference's own properties on the port, and cornell films
under each sampler against the JAX films.

Every sampler function must be ``torch.equal`` to JAX's (the port carries
u32 words as int64, compared here as 32-bit words and as the floats they
become). Films: 32x32, 2 spp, depth 3, at the cornell golden's bar (RGB
RMSE < 1e-3, alpha rtol 1e-5).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.ops import samplers as jsmp
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu_torch.core.film import sample_bounds
from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.ops import samplers as smp
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

torch.set_num_threads(1)

CORNELL = "data/cornell-box.xml"


def _words(n=4096, seed=0):
    """u32 words: random ones, and the edges (0, 1, 2^24 and above, the
    top word)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    h[:6] = [0, 1, 1 << 24, (1 << 24) + 1, 0xFFFFFF7F, 0xFFFFFFFF]
    return torch.as_tensor(h.astype(np.int64)), jnp.asarray(h)


def _eq(got, want):
    """``got`` (int64 words or float32) equal to the JAX array."""
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        assert got.dtype == np.int64 and (got >= 0).all() \
            and (got < (1 << 32)).all()
        got = got.astype(np.uint32)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_hashes_equal_jax():
    th, jh = _words()
    tb, jb = _words(seed=1)
    _eq(smp.hash_u32(th), jsmp.hash_u32(jh))
    _eq(smp.hash_combine(th, tb), jsmp.hash_combine(jh, jb))
    _eq(smp.hash_combine(th, 0x9E3779B9), jsmp.hash_combine(
        jh, jnp.uint32(0x9E3779B9)))
    # u32 -> f32 rounds to nearest above 2^24 in both
    assert (th > (1 << 24)).sum() > 4000
    _eq(smp.uniform_from_hash(th), jsmp.uniform_from_hash(jh))


def test_pixel_hash_of_negative_coordinates_equals_jax():
    """The sample bounds start at floor(0.5 - radius) = -2 for the
    Gaussian filter: the reference hashes ``px.astype(uint32)``, two's
    complement, and so must the port."""
    (x0, y0), (x1, y1) = sample_bounds(8, 6, 2.0)
    assert (x0, y0) == (-2, -2)
    ys, xs = np.mgrid[y0:y1, x0:x1]
    px, py = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    want = jsmp.hash_combine(jnp.asarray(px).astype(jnp.uint32),
                             jsmp.hash_u32(jnp.asarray(py).astype(jnp.uint32)))
    _eq(smp.pixel_hash(torch.as_tensor(px), torch.as_tensor(py)), want)


@pytest.mark.parametrize("log2_n", range(7))
def test_permute_pow2_equals_jax(log2_n):
    th, jh = _words()
    tk, jk = _words(seed=2)
    _eq(smp._permute_pow2(th, log2_n, tk),
        jsmp._permute_pow2(jh, log2_n, jk))


@pytest.mark.parametrize("n", range(1, 25))
def test_permute_general_and_lhs_equal_jax(n):
    """The fixed cycle walk gives the reference's while-loop bits for
    every array size the all-lights strategy can ask (1..24 lights)."""
    rng = np.random.default_rng(n)
    idx = rng.integers(0, n, 4096).astype(np.uint32)
    tk, jk = _words(seed=3)
    _eq(smp.permute_general(torch.as_tensor(idx.astype(np.int64)), n, tk),
        jsmp.permute_general(jnp.asarray(idx), n, jk))
    th, jh = _words(n=512, seed=4)
    for i in sorted({0, n // 2, n - 1}):
        _eq(smp.lhs_2d_dim(th, 7 + i, 11 + n, i, n),
            jsmp.lhs_2d_dim(jh, 7 + i, 11 + n, i, n))


@pytest.mark.parametrize("spp_log2", [0, 1, 3, 4, 5])
def test_stratified_and_random_draws_equal_jax(spp_log2):
    th, jh = _words(n=1024)
    for frame in (0, 1, (1 << spp_log2) - 1):
        for dim in (0, 1, 2, 9, 303):
            _eq(smp.stratified_sample_dim(th, frame, spp_log2, dim),
                jsmp.stratified_sample_dim(jh, frame, spp_log2, dim))
            _eq(smp.stratified_sample_dim2(th, frame, spp_log2, dim),
                jsmp.stratified_sample_dim2(jh, frame, spp_log2, dim))
            _eq(smp.random_sample_dim(th, frame + spp_log2, dim),
                jsmp.random_sample_dim(jh, frame + spp_log2, dim))


# --- the reference's own properties (tests/test_samplers.py) on the port


def _full(n, v):
    return torch.full((n,), v, dtype=torch.int64)


def test_permute_pow2_is_bijection():
    for log2_n in range(0, 7):
        n = 1 << log2_n
        out = smp._permute_pow2(torch.arange(n), log2_n, _full(n, 12345))
        assert sorted(out.tolist()) == list(range(n)), log2_n


def test_stratified_covers_all_strata():
    ph = _full(8, 777)
    strata = set()
    for frame in range(16):
        v = smp.stratified_sample_dim(ph, frame, 4, 3).numpy()
        assert (v >= 0).all() and (v < 1).all()
        s = int(v[0] * 16)
        assert np.all((v * 16).astype(int) == s)
        strata.add(s)
    assert strata == set(range(16))


def test_stratified_decorrelated_across_dims():
    ph = _full(1, 42)
    seq_a = [int(smp.stratified_sample_dim(ph, f, 3, 5)[0] * 8)
             for f in range(8)]
    seq_b = [int(smp.stratified_sample_dim(ph, f, 3, 6)[0] * 8)
             for f in range(8)]
    assert seq_a != seq_b


def test_stratified_2d_pairs_tile_grid():
    for spp_log2, nx, ny in ((4, 4, 4), (3, 4, 2)):
        ph = torch.tensor([777, 1234])
        cells = [set(), set()]
        for frame in range(1 << spp_log2):
            v = smp.stratified_sample_dim2(ph, frame, spp_log2, 3).numpy()
            assert (v >= 0).all() and (v < 1).all()
            for lane in range(2):
                cells[lane].add((int(v[lane, 0] * nx), int(v[lane, 1] * ny)))
        for lane in range(2):
            assert cells[lane] == {(x, y) for x in range(nx)
                                   for y in range(ny)}, (spp_log2, lane)


def test_permute_general_is_bijection():
    for n in (2, 3, 5, 7, 12, 100):
        out = smp.permute_general(torch.arange(n), n, _full(n, 9876))
        assert sorted(out.tolist()) == list(range(n)), n


def test_lhs_2d_latin_property():
    for n in (3, 5, 8):
        ph = torch.tensor([42, 999])
        for frame in (0, 7):
            pts = np.stack([smp.lhs_2d_dim(ph, frame, 11, i, n).numpy()
                            for i in range(n)])
            for lane in range(2):
                xs = sorted((pts[:, lane, 0] * n).astype(int).tolist())
                ys = sorted((pts[:, lane, 1] * n).astype(int).tolist())
                assert xs == list(range(n)), (n, frame, lane)
                assert ys == list(range(n)), (n, frame, lane)


def test_random_sampler_uniform():
    v = smp.random_sample_dim(torch.arange(4096), 0, 9).numpy()
    assert 0.45 < v.mean() < 0.55
    assert (v >= 0).all() and (v < 1).all()


def test_render_with_each_sampler():
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(24, 24), device="cpu")
    means = {}
    for sampler in ("sobol", "stratified", "random"):
        film = PathIntegrator(PathConfig(max_depth=3, sampler=sampler),
                              spp=4).render(cam, sd)
        rgb = (film[..., :3] / torch.clamp_min(film[..., 3:4], 1e-9)).numpy()
        assert np.isfinite(rgb).all(), sampler
        means[sampler] = rgb.mean()
    vals = list(means.values())
    assert max(vals) / min(vals) < 1.25, means


# --- films against the JAX package's


@pytest.mark.parametrize("sampler", ["stratified", "random"])
def test_cornell_film_matches_jax(sampler):
    cfg = dict(max_depth=3, sampler=sampler)
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(32, 32))
    jinteg = JPathIntegrator(JPathConfig(**cfg), spp=2)
    jfilm = np.asarray(jinteg.render(jcam, jsd))
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(32, 32), device="cpu")
    integ = PathIntegrator(PathConfig(**cfg), spp=2)
    film = integ.render(cam, sd).numpy()
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()
    np.testing.assert_allclose(film[..., 3], jfilm[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((film[..., :3] - jfilm[..., :3]) ** 2))
    assert rmse < 1e-3, rmse
    assert abs(integ.last_ray_count - jinteg.last_ray_count) \
        <= 1e-3 * jinteg.last_ray_count


@pytest.mark.parametrize("light_strategy", ["one", "all"])
@pytest.mark.parametrize("sampler", ["stratified", "random"])
def test_chunked_render_equals_whole(sampler, light_strategy, tmp_path):
    """Each chunk draws from frame ``frame_base`` on with the whole
    render's spp, so chunks of 1 spp, and a checkpoint resumed, give the
    whole render's film bit for bit."""
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(12, 10), device="cpu")
    cfg = PathConfig(max_depth=2, sampler=sampler,
                     light_strategy=light_strategy)
    whole = PathIntegrator(cfg, spp=4).render(cam, sd)
    integ = PathIntegrator(cfg, spp=4)
    chunks = integ.render_progressive(cam, sd, chunk_spp=1)
    assert torch.equal(chunks, whole)
    ck = str(tmp_path / "ck.npz")
    stop = []

    def halt(film, done):
        if done == 2:
            stop.append(done)
            raise KeyboardInterrupt
    with pytest.raises(KeyboardInterrupt):
        PathIntegrator(cfg, spp=4).render_progressive(
            cam, sd, chunk_spp=1, callback=halt, checkpoint=ck)
    assert stop == [2]
    resumed = PathIntegrator(cfg, spp=4).render_progressive(
        cam, sd, chunk_spp=1, checkpoint=ck)
    assert torch.equal(resumed, whole)


def test_hash_samplers_build_no_sobol_statics(monkeypatch):
    """The stratified and random samplers read no Sobol table, so the
    render builds none."""
    from pathtracer_tpu_torch.ops import sobol

    def refuse(*args, **kwargs):
        raise AssertionError("Sobol statics built for a hash sampler")
    for name in ("pixel_statics", "frame_statics", "vdc_inv_rows",
                 "sm32_device"):
        monkeypatch.setattr(sobol, name, refuse)
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(8, 8), device="cpu")
    for sampler in ("stratified", "random"):
        film = PathIntegrator(PathConfig(max_depth=1, sampler=sampler),
                              spp=2).render(cam, sd)
        assert torch.isfinite(film).all() and (film[..., 3] > 0).all()


def test_unknown_sampler_and_strategy_raise():
    for cfg in (PathConfig(sampler="halton"),
                PathConfig(light_strategy="some")):
        with pytest.raises(ValueError):
            PathIntegrator(cfg)
