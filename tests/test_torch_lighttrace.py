"""The light tracer: the port against the JAX package, and against its
own path tracer.

``project_points`` inverts ray generation; ``_splat`` and one
``_lt_wave`` (cornell 32x32, n = 4096, depth 3) match JAX's at rtol 1e-4
/ atol 1e-6 when both are fed the same uniforms: the reference draws them
with ``jax.random`` inside the wave (``split(fold_in(PRNGKey(seed), i),
3 + depth)``), the port takes them as arguments, so the test makes them
the reference's way and hands the port the same bits. The port's own
renders draw from a torch.Generator instead (ROADMAP Queue 3), so whole
films agree with JAX's in expectation only: block means, ``slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import integrator_lt as jlt
from pathtracer_tpu.core import film as jfilm_mod
from pathtracer_tpu.core.camera import project_points as jproject_points
from pathtracer_tpu.integrator import TracedScene as JTracedScene
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu_torch import integrator_lt as plt
from pathtracer_tpu_torch.core.camera import (Camera, generate_rays,
                                              project_points)
from pathtracer_tpu_torch.core.film import add_samples, film_new
from pathtracer_tpu_torch.core.filter import make_filter
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.interop import camera_from_reference
from pathtracer_tpu_torch.scene import meshgen
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.procedural import _plane_matrix
from pathtracer_tpu_torch.scene.scene import MAT_MATTE, SceneBuilder

torch.set_num_threads(1)

CORNELL = "data/cornell-box.xml"
RES = (32, 32)


def _mean_img(film):
    a = film.numpy() if isinstance(film, torch.Tensor) else np.asarray(film)
    return a[..., :3] / np.maximum(a[..., 3:4], 1e-9)


def _blocks(img, k):
    h, w, _ = img.shape
    return img.reshape(h // k, k, w // k, k, 3).mean((1, 3))


def _cornell():
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=RES)
    cam, sd, _ = load_mitsuba(CORNELL, resolution=RES, device="cpu")
    return (jcam, JTracedScene.create(jsd)), (cam, TracedScene.create(sd))


def test_project_inverts_raygen():
    cam = Camera.look_at([1.0, 2.0, 5.0], [0.0, 0.5, 0.0], [0, 1, 0],
                         np.pi / 3, (64, 48))
    rng = np.random.default_rng(2)
    p_film = torch.as_tensor(
        rng.random((256, 2), np.float32) * np.asarray([64, 48], np.float32))
    o, d = generate_rays(*cam.ray_params("cpu"), p_film)
    t = torch.as_tensor(1.0 + 9.0 * rng.random(256).astype(np.float32))
    c2r, w2c_rot, w2c_pos, fwd, imp = cam.project_params("cpu")
    raster, z_cam = project_points(c2r, w2c_rot, w2c_pos,
                                   o + t[:, None] * d)
    assert (z_cam.numpy() < 0).all()
    np.testing.assert_allclose(raster.numpy(), p_film.numpy(), rtol=1e-3,
                               atol=5e-3)
    assert float(imp) > 0


def test_project_params_and_points_match_jax():
    (jcam, _), (cam, _) = _cornell()
    params = cam.project_params("cpu")
    jparams = jcam.project_params()
    for got, want in zip(params, jparams):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    rng = np.random.default_rng(4)
    p = rng.uniform(-3, 8, (2048, 3)).astype(np.float32)
    raster, z = project_points(*params[:3], torch.as_tensor(p))
    jraster, jz = jproject_points(*jparams[:3], jnp.asarray(p))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(raster.numpy(), np.asarray(jraster),
                               rtol=1e-4, atol=1e-3)


def _points(n, seed):
    """Points in and around the cornell room, with normals and values;
    some behind the camera, some off the image."""
    rng = np.random.default_rng(seed)
    p = rng.uniform([-1.2, -0.2, -1.2], [1.2, 2.2, 8.0], (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    value = rng.uniform(0, 2, (n, 3))
    alive = rng.random(n) < 0.9
    perr = np.full((n, 3), 1e-6)
    return [a.astype(np.float32) for a in (p, perr, nrm, value)] + [alive]


def test_splat_matches_jax():
    (jcam, jts), (cam, ts) = _cornell()
    p, perr, nrm, value, alive = _points(4096, 5)
    jfilm = jlt._splat(jts, jcam.project_params(), jnp.zeros((32, 32, 3)),
                       jnp.asarray(p), jnp.asarray(perr), jnp.asarray(nrm),
                       jnp.asarray(value), jnp.asarray(alive))
    film = torch.zeros((32 * 32 + 1, 3))
    film = plt._splat(ts, cam.project_params("cpu"), film, RES,
                      *(torch.as_tensor(a) for a in (p, perr, nrm, value,
                                                     alive)))
    got = film[:-1].view(32, 32, 3).numpy()
    assert (got > 0).sum() > 100
    np.testing.assert_allclose(got, np.asarray(jfilm), rtol=1e-4, atol=1e-6)
    assert (film[-1] == 0).all()


def test_points_off_the_image_or_not_finite_add_nothing():
    """NaN, infinite, off-image and behind-camera points never index the
    film (on the card an out-of-range index ends the process): they add
    nothing, and the points in the image still add."""
    (_, _), (cam, ts) = _cornell()
    params = cam.project_params("cpu")
    good = np.array([[0.0, 1.0, 0.0]], np.float32)
    bad = np.array([[np.nan, 1.0, 0.0], [np.inf, 1.0, 0.0],
                    [0.0, -np.inf, 0.0], [0.0, 1.0, np.inf],
                    [40.0, 1.0, 0.0], [0.0, 1.0, 9.0],
                    [1e30, 1e30, -1e30]], np.float32)
    n = len(bad) + 1
    p = torch.as_tensor(np.concatenate([bad, good]))
    zeros = torch.zeros((n, 3))
    nrm = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    value = torch.ones((n, 3))
    alive = torch.ones(n, dtype=torch.bool)
    film = plt._splat(ts, params, torch.zeros((32 * 32 + 1, 3)), RES, p,
                      zeros, nrm, value, alive)
    assert torch.isfinite(film).all()
    assert int((film[:-1].sum(-1) > 0).sum()) == 1
    only_bad = plt._splat(ts, params, torch.zeros((32 * 32 + 1, 3)), RES,
                          p[:-1], zeros[:-1], nrm[:-1], value[:-1],
                          alive[:-1])
    assert (only_bad == 0).all()


def _jax_draws(seed, wave, n, depth):
    """The reference's uniforms of one wave (integrator_lt._lt_wave)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), wave)
    ks = jax.random.split(key, 3 + depth)
    u_pick = jax.random.uniform(ks[0], (n,))
    u_pos = jax.random.uniform(ks[1], (n, 2))
    u_dir = jax.random.uniform(ks[2], (n, 2))
    u_bounce = [jax.random.uniform(ks[3 + k], (n, 2))
                for k in range(depth - 1)]
    return key, [torch.as_tensor(np.array(u))
                 for u in (u_pick, u_pos, u_dir)], \
        [torch.as_tensor(np.array(u)) for u in u_bounce]


def test_wave_matches_jax_on_shared_draws():
    (jcam, jts), (cam, ts) = _cornell()
    n, depth = 4096, 3
    key, (u_pick, u_pos, u_dir), u_bounce = _jax_draws(0, 0, n, depth)
    jfilm = np.asarray(jlt._lt_wave(jts, jnp.zeros((32, 32, 3)), key,
                                    jcam.project_params(), depth=depth, n=n))
    film = plt._lt_wave(ts, torch.zeros((32 * 32 + 1, 3)), RES,
                        cam.project_params("cpu"), depth, u_pick, u_pos,
                        u_dir, u_bounce)
    got = film[:-1].view(32, 32, 3).numpy()
    assert jfilm.sum() > 0 and (jfilm > 0).mean() > 0.5
    np.testing.assert_allclose(got, jfilm, rtol=1e-4, atol=1e-6)


def test_light_tracer_film_and_ray_count():
    """The film is finite with alpha 1, the same on a second render (the
    draws are seeded), and the ray count is the reference's."""
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(16, 16), device="cpu")
    ltr = plt.LightTracer(PathConfig(max_depth=2), paths=5000, wave=2048,
                          seed=3)
    assert (ltr.waves, ltr.paths) == (3, 6144)
    film = ltr.render(cam, sd)
    assert film.shape == (16, 16, 4) and torch.isfinite(film).all()
    assert (film[..., 3] == 1).all() and film[..., :3].sum() > 0
    assert ltr.last_ray_count == 6144 * 5
    assert torch.equal(ltr.render(cam, sd), film)
    u = plt.wave_draws(3, 1, 2048, 2)
    assert [tuple(x.shape) for x in u[:3]] == [(2048,), (2048, 2),
                                               (2048, 2)]
    assert len(u[3]) == 1 and not torch.equal(u[1], plt.wave_draws(
        3, 2, 2048, 2)[1])


def test_film_new_and_add_samples_match_jax():
    rng = np.random.default_rng(8)
    p_film = rng.uniform(-3, 19, (512, 2)).astype(np.float32)
    rad = rng.uniform(0, 3, (512, 3)).astype(np.float32)
    table, radius = make_filter()
    film = add_samples(film_new(16, 12, device="cpu"),
                       torch.as_tensor(p_film), torch.as_tensor(rad), table,
                       radius)
    jfilm = jfilm_mod.add_samples(jfilm_mod.film_new(16, 12),
                                  jnp.asarray(p_film), jnp.asarray(rad),
                                  jnp.asarray(table), radius)
    assert film.shape == (12, 16, 4)
    np.testing.assert_allclose(film.numpy(), np.asarray(jfilm), rtol=1e-5,
                               atol=1e-5)


def test_lt_matches_pt_point_light():
    """Floor plane + point light (tests/test_lighttrace.py) on the port:
    the sphere-emission branch of sample_le end to end."""
    b = SceneBuilder()
    mat = b.add_material(mtype=MAT_MATTE, kd=(0.6, 0.4, 0.2))
    pos, idx, nrm, _ = meshgen.gen_rectangle()
    p, n = meshgen.transform_mesh(pos, nrm, _plane_matrix(
        [4, 0, 0], [0, 0, -4], [0, 0, 0]))
    b.add_mesh(p, idx, n, None, mat)
    b.add_point_light([0.0, 2.0, 0.0], (6.0, 6.0, 6.0))
    sd = b.build(device="cpu")
    cam = Camera.look_at([0, 3, 4], [0, 0, 0], [0, 1, 0], np.pi / 3,
                         (32, 32))
    cfg = PathConfig(max_depth=1)
    pt = _mean_img(PathIntegrator(cfg, spp=16).render(cam, sd))
    lt_img = _mean_img(plt.LightTracer(cfg, paths=1 << 17, wave=1 << 15,
                                       seed=1).render(cam, sd))
    pb = _blocks(pt[16:, :, :], 8)
    lb = _blocks(lt_img[16:, :, :], 8)
    assert pb.mean() > 0.01
    np.testing.assert_allclose(lb.mean(), pb.mean(), rtol=0.05)
    np.testing.assert_allclose(lb, pb, rtol=0.2, atol=5e-3)


@pytest.mark.slow
def test_lt_matches_pt_and_jax_cornell():
    """Cornell: the port's light tracer against its path tracer (as
    tests/test_lighttrace.py) and against the JAX light tracer, in 8x8
    block means (independent draws: within Monte Carlo noise)."""
    cam, sd, _ = load_mitsuba(CORNELL, resolution=RES, device="cpu")
    cfg = PathConfig(max_depth=2)
    pt = _mean_img(PathIntegrator(cfg, spp=64).render(cam, sd))
    lt_img = _mean_img(plt.LightTracer(cfg, paths=1 << 18, wave=1 << 16,
                                       seed=3).render(cam, sd))
    assert pt.mean() > 0.01
    np.testing.assert_allclose(lt_img.mean(), pt.mean(), rtol=0.05)
    np.testing.assert_allclose(_blocks(lt_img, 8), _blocks(pt, 8),
                               rtol=0.25, atol=0.01)
    from pathtracer_tpu.integrator import PathConfig as JPathConfig
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=RES)
    j_img = _mean_img(jlt.LightTracer(JPathConfig(max_depth=2),
                                      paths=1 << 18, wave=1 << 16,
                                      seed=3).render(jcam, jsd))
    assert camera_from_reference(jcam).resolution == cam.resolution
    np.testing.assert_allclose(lt_img.mean(), j_img.mean(), rtol=0.03)
    np.testing.assert_allclose(_blocks(lt_img, 8), _blocks(j_img, 8),
                               rtol=0.2, atol=0.01)
