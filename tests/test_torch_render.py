"""The PyTorch port's Cornell slice as a whole, against the JAX package.

Both packages load the same Mitsuba file; the films are held to the
cornell golden's bar (RMSE < 1e-3 on RGB, alpha to rtol 1e-5), which the
two meet with ~1e-7 to spare because both run the same Sobol samples and
the same f32 arithmetic.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.interop import (camera_from_reference,
                                          scene_from_reference)
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from torch_leaves import assert_scene_equal

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")
GOLDEN = os.path.join(ROOT, "tests", "golden_cornell_32.npz")


def _assert_film_close(got, want):
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2))
    assert rmse < 1e-3, rmse


def test_load_mitsuba_matches_reference():
    cam, sd, settings = load_mitsuba(CORNELL, resolution=(64, 48),
                                     device="cpu")
    jcam, jsd, jsettings = jload_mitsuba(CORNELL, resolution=(64, 48))
    assert settings == jsettings
    assert_scene_equal(sd, jsd)
    for f in dataclasses.fields(cam):
        np.testing.assert_array_equal(np.asarray(getattr(cam, f.name)),
                                      np.asarray(getattr(jcam, f.name)),
                                      err_msg=f.name)
    # interop gives the same SceneData from the reference's own
    sd2 = scene_from_reference(jsd, device="cpu")
    assert_scene_equal(sd2, sd)


def test_cornell_32_matches_golden_and_jax_film():
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(32, 32), device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=3), spp=2)
    film = integ.render(cam, sd).numpy()
    assert film.shape == (32, 32, 4)
    _assert_film_close(film, np.load(GOLDEN)["film"])
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(32, 32))
    jinteg = JPathIntegrator(JPathConfig(max_depth=3), spp=2)
    jfilm = np.asarray(jinteg.render(jcam, jsd))
    _assert_film_close(film, jfilm)
    # the same waves count the same rays, up to the few grazing lanes
    # whose shadow/RR outcome flips with XLA's jit fusion (the eager JAX
    # bounce gives the port's count exactly)
    assert abs(integ.last_ray_count - jinteg.last_ray_count) \
        <= 1e-3 * jinteg.last_ray_count
    assert integ.bad_sample_count == 0.0


def test_cornell_onesample_matches_jax_film():
    cfg = dict(max_depth=2, mis_mode="onesample")
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(16, 16))
    jfilm = np.asarray(JPathIntegrator(JPathConfig(**cfg), spp=1)
                       .render(jcam, jsd))
    # the JAX scene through interop: both packages render identical data
    film = PathIntegrator(PathConfig(**cfg), spp=1).render(
        camera_from_reference(jcam),
        scene_from_reference(jsd, device="cpu")).numpy()
    _assert_film_close(film, jfilm)
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()


@pytest.mark.parametrize("mis_mode", ["ref", "onesample"])
def test_depth5_wave_matches_jax_bounce_loop(mis_mode):
    """Depth 5 reaches Russian roulette (bounces above rr_start_depth). The
    jitted JAX render flips a few grazing paths there (XLA fusion), so the
    wave is held against the JAX bounce functions run op by op, on the
    same camera rays and Sobol draws: same live lanes and ray counts after
    every bounce, radiance to 1e-6."""
    import jax.numpy as jnp
    from pathtracer_tpu import integrator as ji
    from pathtracer_tpu.ops import sobol as jsb
    from pathtracer_tpu_torch import integrator as pi
    from pathtracer_tpu_torch.ops import sobol as psb

    res = 12
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(res, res))
    jts = ji.TracedScene.create(jsd, use_pallas=False)
    pts = pi.TracedScene.create(scene_from_reference(jsd, device="cpu"))
    jcfg = ji.PathConfig(max_depth=5, mis_mode=mis_mode)
    pcfg = pi.PathConfig(max_depth=5, mis_mode=mis_mode)
    dom = jsb.SobolDomain.create((-2, -2), (res + 2, res + 2), 1)
    ys, xs = np.mgrid[-2:res + 2, -2:res + 2]
    px, py = xs.ravel(), ys.ravel()
    scr, b_base = jsb.pixel_statics(dom, px, py)
    lo_s, hi_s, delta = jsb.frame_statics(dom, 0)
    jlo, jhi = jsb.sobol_index(jnp.asarray(b_base), jnp.uint32(delta),
                               jnp.uint32(lo_s), jnp.uint32(hi_s),
                               *jsb.vdc_inv_rows(dom))
    plo, phi = psb.sobol_index(torch.as_tensor(b_base.astype(np.int64)),
                               int(delta), int(lo_s), int(hi_s),
                               *psb.vdc_inv_rows(dom, "cpu"))
    jsm, psm = jsb.sm32_device(), psb.sm32_device("cpu")
    jscr = jnp.asarray(scr)
    pscr = torch.as_tensor(scr.astype(np.int64))
    jdraws = (lambda k: jsb.sobol_sample_dim(jlo, jhi, k, jscr, jsm),
              lambda k: jsb.sobol_sample_dim2(jlo, jhi, k, jscr, jsm))
    pdraws = (lambda k: psb.sobol_sample_dim(plo, phi, k, pscr, psm),
              lambda k: psb.sobol_sample_dim2(plo, phi, k, pscr, psm))
    rng = np.random.default_rng(3)
    pf = np.stack([px, py], -1) + rng.uniform(0, 1, (len(px), 2))
    o, d = ji.generate_rays(*jcam.ray_params(),
                            jnp.asarray(pf.astype(np.float32)))
    jst = ji._wave_init(jts, jcfg, o, d)
    pst = pi._wave_init(pts, pcfg, torch.tensor(np.asarray(o)),
                        torch.tensor(np.asarray(d)))
    for bounce in range(jcfg.max_depth + 1):
        jst = ji._wave_bounce(jts, jcfg, bounce, jst, *jdraws)
        pst = pi._wave_bounce(pts, pcfg, bounce, pst, *pdraws)
        np.testing.assert_array_equal(pst["active"].numpy(),
                                      np.asarray(jst["active"]))
        assert float(pst["rays"]) == float(jst["rays"])
        np.testing.assert_allclose(pst["l"].numpy(), np.asarray(jst["l"]),
                                   rtol=1e-5, atol=1e-6)
    assert float(jst["rays"]) > 4 * len(px)  # deep paths really ran


@pytest.mark.parametrize("kwargs", [
    dict(sampler="stratified"), dict(light_strategy="all"),
    dict(count_occupancy=True)])
def test_options_outside_the_slice_raise(kwargs):
    """The options once outside the port's first slice: the stratified
    sampler, the all-lights strategy and count_occupancy (ported with the
    frontends, which fills ``bounce_occupancy``) all render."""
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(8, 8), device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=1, **kwargs), spp=1)
    film = integ.render(cam, sd)
    assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
    if kwargs.get("count_occupancy"):
        # bounce 0 counts every camera lane of the 12 x 12 sample rectangle
        assert integ.bounce_occupancy.tolist()[0] == 12 * 12
        assert len(integ.bounce_occupancy) == 2


def test_port_render_imports_no_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba\n"
        "from pathtracer_tpu_torch.integrator import PathConfig, "
        "PathIntegrator\n"
        f"cam, sd, _ = load_mitsuba({CORNELL!r}, resolution=(8, 8), "
        "device='cpu')\n"
        "film = PathIntegrator(PathConfig(max_depth=2), spp=1)"
        ".render(cam, sd)\n"
        "assert torch.isfinite(film).all()\n"
        "from pathtracer_tpu_torch.scene.procedural import box_field_scene\n"
        "cam, sd = box_field_scene((8, 6), n_boxes=30, device='cpu')\n"
        "film = PathIntegrator(PathConfig(max_depth=2), spp=1)"
        ".render(cam, sd)\n"
        "assert torch.isfinite(film).all()\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "assert not [m for m in sys.modules if m.startswith('jax')]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
