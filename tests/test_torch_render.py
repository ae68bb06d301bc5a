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
import types

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
    dict(sampler="stratified"), dict(light_strategy="all"), dict()])
def test_options_outside_the_slice_raise(kwargs):
    """The options once outside the port's first slice: the stratified
    sampler, the all-lights strategy and the occupancy count (ported with
    the frontends as ``count_occupancy``, now always on: it fills
    ``bounce_occupancy``) all render."""
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(8, 8), device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=1, **kwargs), spp=1)
    film = integ.render(cam, sd)
    assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
    # bounce 0 counts every camera lane of the 12 x 12 sample rectangle
    assert integ.bounce_occupancy.tolist()[0] == 12 * 12
    assert len(integ.bounce_occupancy) == 2


def _cuda_stand_in(ts):
    """What ``_graph_engages`` reads of a traced scene, as if on a card."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 has_alpha=ts.has_alpha)


@pytest.mark.parametrize("case", [
    "card", "cpu", "brute", "dense", "tree", "binary", "count_occupancy",
    "stratified", "random"])
def test_graph_engages_only_where_a_capture_holds_the_band_frame(case):
    """The CUDA graph takes cornell's band-frames on a card and nowhere
    else: not on the CPU, not for any alpha route (split subset, dense
    pass, its own table, the all-masked binary tree, K1's retries), not
    under the hash samplers. The occupancy count (once the JAX package's
    opt-in ``count_occupancy``, which kept the graph off) is always on and
    keeps it off no more."""
    from pathtracer_tpu_torch.integrator import TracedScene, _graph_engages
    from pathtracer_tpu_torch.scene.scene import SceneBuilder
    from torch_alpha_scenes import ROUTES, build
    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    if case in ROUTES:
        fill, use_bvh, attr = ROUTES[case]
        ts = TracedScene.create(build(SceneBuilder, fill), use_bvh=use_bvh)
        route = True if attr is None else getattr(ts, attr)
        assert ts.has_alpha and route is not None and route is not False
    else:
        _, sd, _ = load_mitsuba(CORNELL, resolution=(8, 8), device="cpu")
        ts = TracedScene.create(sd)
        assert not ts.has_alpha
    if case in ("stratified", "random"):
        cfg = dataclasses.replace(cfg, sampler=case)
    scene = ts if case == "cpu" else _cuda_stand_in(ts)
    assert _graph_engages(scene, cfg) == (case in ("card", "count_occupancy"))
    assert not hasattr(cfg, "count_occupancy")


def test_cpu_render_counts_its_band_frames_eager():
    """A CPU render runs every band-frame eagerly and says so in
    GRAPH_COUNTS: bands x spp under "eager", no capture, no replay."""
    from pathtracer_tpu_torch import integrator as pint
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(16, 12), device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=2, mis_mode="onesample"),
                           spp=4, band_rows=6)
    before = dict(pint.GRAPH_COUNTS)
    integ.render_progressive(cam, sd, chunk_spp=2)
    got = {k: v - before[k] for k, v in pint.GRAPH_COUNTS.items()}
    assert got == dict(captures=0, replays=0,
                       eager=integ.band_layout(cam)[1] * 4)
    assert integ.band_layout(cam)[1] == 3


def test_one_band_graph_a_device_and_one_trace_a_scene_data(monkeypatch):
    """A SceneData passed again is traced once (its TracedScene, and so
    its graphs, are reused). The integrator keeps one captured
    band-frame a device: a moved camera finds it, as its buffers take the
    camera; another band shape or another scene replaces it."""
    from pathtracer_tpu_torch import integrator as pint
    made = []

    class StandIn:
        def __init__(self, integ, su, band):
            made.append(self)

    monkeypatch.setattr(pint, "_BandGraph", StandIn)
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(16, 12), device="cpu")
    moved = dataclasses.replace(cam, cam_to_world=cam.cam_to_world * 1.01)
    integ = PathIntegrator(PathConfig(max_depth=2), spp=4, band_rows=6)

    def graph(camera, scene):
        su = integ.setup(camera, scene)
        return su, integ._band_graph(su, integ.band(su, su.y0, 6, su.y1))

    su, g = graph(cam, sd)
    su2, g2 = graph(moved, sd)
    assert su2.scene is su.scene and g2 is g and len(made) == 1
    wide = dataclasses.replace(cam, resolution=(20, 12))
    _, g3 = graph(wide, su.scene)
    assert g3 is not g and list(integ._graphs.values()) == [g3]
    _, g4 = graph(wide, sd)  # the same TracedScene: the same graph
    assert g4 is g3
    _, sd_b, _ = load_mitsuba(CORNELL, resolution=(20, 12), device="cpu")
    su5, g5 = graph(wide, sd_b)
    assert su5.scene is not su.scene and g5 is not g3
    assert list(integ._graphs.values()) == [g5] and len(made) == 3


def test_a_band_graphs_staged_records_give_the_eager_band_frame(
        monkeypatch):
    """The buffers a captured band-frame reads, filled with garbage and
    then staged from another camera's set-up and another band, give that
    band-frame's eager bits (run here on the CPU, without a capture):
    ``stage`` fills every field ``band_frame`` reads, the floats as 0-d
    float32 tensors, and the words as 0-d int64 tensors read alike."""
    from pathtracer_tpu_torch import integrator as pint
    from pathtracer_tpu_torch.ops import sobol as sb
    monkeypatch.setattr(pint, "SpanGraph", lambda device: None)
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(16, 12), device="cpu")
    moved = dataclasses.replace(cam, cam_to_world=cam.cam_to_world * 1.01)
    integ = PathIntegrator(PathConfig(max_depth=2, mis_mode="onesample"),
                           spp=4, band_rows=6)
    su = integ.setup(cam, sd)
    graph = pint._BandGraph(integ, su, integ.band(su, su.y0, 6, su.y1))
    assert isinstance(graph.su.sobol_scale, torch.Tensor)
    for record in (graph.su, graph.band):
        for v in vars(record).values():
            if isinstance(v, torch.Tensor):
                v.fill_(-7)
    su2 = integ.setup(moved, sd)
    band2 = integ.band(su2, su2.y0 + 6, 6, su2.y1)
    graph.stage(su2, band2)
    words = tuple(int(w) for w in sb.frame_statics(su2.domain, 3))
    graph.words = tuple(torch.tensor(w) for w in words)
    occ = torch.zeros(3)
    want = pint.band_frame(su2.scene, integ.cfg, su2, band2, words,
                           occupancy=occ)
    got = graph._body()
    assert len(got) == 4
    for g, w in zip(got, want + (occ,)):
        assert torch.equal(g, w)


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
