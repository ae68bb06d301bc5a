"""The port's core math, sampling warps, camera and film against the JAX
package on the same numpy inputs.

Float bit tricks (next_float_up/down, offset_ray_origin) must match
exactly; camera rays, warps and the film splat to 1e-6.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.core import camera as jcam
from pathtracer_tpu.core import film as jfilm
from pathtracer_tpu.core import math as jm
from pathtracer_tpu.core import sampling as jsamp
from pathtracer_tpu.core.filter import filter_f1d
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu_torch.core import camera as pcam
from pathtracer_tpu_torch.core import film as pfilm
from pathtracer_tpu_torch.core import math as pm
from pathtracer_tpu_torch.core import sampling as psamp
from pathtracer_tpu_torch.interop import camera_from_reference

torch.set_num_threads(1)

TINY = np.finfo(np.float32).tiny  # smallest normal float32
SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, TINY, -TINY,
                    np.finfo(np.float32).max, -np.finfo(np.float32).max,
                    3.5, -7.25], np.float32)


def _floats(seed, n=4096):
    """Normal floats of every magnitude plus the special values. XLA on
    the CPU flushes subnormals to zero, so they get their own test."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 10.0 ** rng.integers(-30, 30, n))
    return np.concatenate([SPECIAL, x.astype(np.float32)])


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", ["next_float_up", "next_float_down"])
def test_next_float_bit_exact(name):
    x = _floats(0)
    got = getattr(pm, name)(torch.as_tensor(x)).numpy()
    want = np.asarray(getattr(jm, name)(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name,toward", [("next_float_up", np.inf),
                                         ("next_float_down", -np.inf)])
def test_next_float_keeps_subnormals(name, toward):
    """The port steps through IEEE subnormals like np.nextafter (the JAX
    package on the CPU flushes them to zero first: a recorded divergence
    that no scene coordinate reaches)."""
    x = np.array([1e-45, -1e-45, 1e-38, -1e-38, TINY, -TINY], np.float32)
    got = getattr(pm, name)(torch.as_tensor(x)).numpy()
    want = np.nextafter(x, np.float32(toward))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_offset_ray_origin_bit_exact():
    rng = np.random.default_rng(1)
    n = 4096
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    p_err = np.abs(rng.normal(size=(n, 3)) * 1e-6).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    p[:16] = 0.0  # origins on the axes planes: +-0 handling
    got = pm.offset_ray_origin(*(torch.as_tensor(a)
                                 for a in (p, p_err, nrm, w))).numpy()
    want = np.asarray(jm.offset_ray_origin(*(jnp.asarray(a)
                                             for a in (p, p_err, nrm, w))))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_small_math_matches():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(512, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = rng.normal(size=(512, 3)).astype(np.float32)
    tv, tw = torch.as_tensor(v), torch.as_tensor(w)
    for got, want in [
            (pm.coordinate_system(tv), jm.coordinate_system(jnp.asarray(v))),
            ((pm.cross(tv, tw),), (jnp.cross(v, w),)),
            ((pm.face_forward(tv, tw),), (jm.face_forward(v, w),)),
            ((pm.normalize(tw),), (jm.normalize(jnp.asarray(w)),))]:
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)
    f, g = np.abs(w[:, 0]), np.abs(w[:, 1])
    np.testing.assert_allclose(
        pm.power_heuristic(1.0, torch.as_tensor(f), 1.0,
                           torch.as_tensor(g)).numpy(),
        np.asarray(jm.power_heuristic(1.0, f, 1.0, g)), rtol=1e-6)
    for n in (1, 2, 5, 17, 64):
        assert pm.gamma(n) == jm.gamma(n)
        assert pm.round_up_pow2(n) == jm.round_up_pow2(n)


@pytest.mark.parametrize("name", ["concentric_sample_disk",
                                  "cosine_sample_hemisphere",
                                  "uniform_sample_triangle"])
def test_warps_match(name):
    rng = np.random.default_rng(3)
    u = rng.uniform(0, 1, (2048, 2)).astype(np.float32)
    u[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.0], [0.0, 0.5]]
    got = getattr(psamp, name)(torch.as_tensor(u)).numpy()
    want = np.asarray(getattr(jsamp, name)(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_camera_and_generate_rays_match():
    ref, _, _ = jload_mitsuba("data/cornell-box.xml", resolution=(64, 48))
    cam = camera_from_reference(ref)
    for got, want in zip(cam.ray_params("cpu"), ref.ray_params()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(4)
    pf = rng.uniform(-2, 66, (4096, 2)).astype(np.float32)
    o, d = pcam.generate_rays(*cam.ray_params("cpu"), torch.as_tensor(pf))
    jo, jd = jcam.generate_rays(*ref.ray_params(), jnp.asarray(pf))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    # an independent camera: look_at gives the reference's matrices
    args = ([0, 1, 5], [0, 1, 0], [0, 1, 0], 0.6, (32, 24))
    a, b = pcam.Camera.look_at(*args), jcam.Camera.look_at(*args)
    np.testing.assert_array_equal(a.raster_to_camera, b.raster_to_camera)
    np.testing.assert_array_equal(a.cam_to_world, b.cam_to_world)


@pytest.mark.parametrize("kind", ["gaussian", "triangle"])
def test_splat_and_accumulate_match(kind):
    f1d, radius = filter_f1d(kind)
    f1d = tuple(float(v) for v in f1d)
    w, h = 20, 12
    (x0, y0), (x1, y1) = pfilm.sample_bounds(w, h, radius)
    assert ((x0, y0), (x1, y1)) == jfilm.sample_bounds(w, h, radius)
    th, tw = 9, x1 - x0
    rng = np.random.default_rng(5)
    rad = rng.uniform(0, 4, (th, tw, 3)).astype(np.float32)
    jx = rng.uniform(0, 1, (th, tw)).astype(np.float32)
    jy = rng.uniform(0, 1, (th, tw)).astype(np.float32)
    valid = rng.uniform(size=(th, tw)) < 0.9
    half = pfilm.splat_halfwidth(radius)
    assert half == jfilm.splat_halfwidth(radius)
    film = pfilm.film_pad_new(w, h, extra_rows=th, device="cpu")
    jf = jfilm.film_pad_new(w, h, extra_rows=th)
    for band_y0 in (y0, y0 + th):  # two bands: the second overlaps the pad
        tile = pfilm.splat_tile(torch.as_tensor(rad), torch.as_tensor(jx),
                                torch.as_tensor(jy), torch.as_tensor(valid),
                                f1d, radius=radius)
        jt = jfilm.splat_tile(jnp.asarray(rad), jnp.asarray(jx),
                              jnp.asarray(jy), jnp.asarray(valid), f1d,
                              radius=radius)
        np.testing.assert_allclose(tile.numpy(), np.asarray(jt), rtol=1e-6,
                                   atol=1e-6)
        film = pfilm.film_pad_accumulate(film, tile, x0, band_y0, half=half)
        jf = jfilm.film_pad_accumulate(jf, jt, x0, band_y0, half=half)
    got = pfilm.film_crop(film, w, h)
    want = jfilm.film_crop(jf, w, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(pfilm.to_rgb8(got), jfilm.to_rgb8(want))
