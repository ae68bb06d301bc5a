"""The port's interactive viewer: the cases of tests/test_viewer.py on
the port, and the port against the JAX package on the same inputs.

The camera controllers are numpy on both sides: their matrices are held
to the JAX package's at 1e-12. The preview's primary-visibility wave is
held to the JAX package's at atol 1e-5 (the same f32 shading; the hits
agree lane for lane), and the BVH overlay's boxes to the JAX package's
exactly (both read the same BVH32 table layout, built by the same C++
code, ``bvh_builder.cpp``).
"""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.core.camera import Camera
from pathtracer_tpu_torch.core.controller import (FirstPersonCameraController,
                                                  OrbitalCameraController)
from pathtracer_tpu_torch.frontend.interactive import (ViewerState,
                                                       bvh_level_boxes,
                                                       dispatch_key,
                                                       draw_bvh_bounds,
                                                       preview_frame,
                                                       project_points, run)
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.scene import procedural
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")


def _cam(eye=(0.0, 0.0, 5.0), center=(0.0, 0.0, 0.0)):
    return Camera.look_at(eye, center, (0, 1, 0), fovy=np.radians(45),
                          resolution=(32, 32))


def _cornell(resolution, **kw):
    cam, sd, _ = load_mitsuba(CORNELL, resolution=resolution, device="cpu")
    return cam, TracedScene.create(sd, **kw)


def test_orbit_preserves_radius_and_aims_at_pivot():
    cam = _cam()
    ctl = OrbitalCameraController(pivot=(0, 0, 0), orbit_speed=1.0)
    ctl.process_mouse(30.0, 10.0)
    cam2 = ctl.update_camera(cam, dt=1.0)
    p = cam2.cam_to_world[:3, 3]
    np.testing.assert_allclose(np.linalg.norm(p), 5.0, rtol=1e-6)
    # camera looks down -z toward the pivot
    fwd = -cam2.cam_to_world[:3, 2]
    np.testing.assert_allclose(fwd, -p / np.linalg.norm(p), atol=1e-6)
    # the eye actually moved
    assert np.linalg.norm(p - cam.cam_to_world[:3, 3]) > 0.5
    # accumulators reset
    assert ctl.rotate_horizontal == ctl.rotate_vertical == 0.0


def test_orbit_zoom_clamps_radius():
    cam = _cam()
    ctl = OrbitalCameraController(pivot=(0, 0, 0), zoom_speed=1.0)
    ctl.process_scroll(-0.5)  # zoom in: radius * (1 - 0.5)
    cam2 = ctl.update_camera(cam, dt=1.0)
    np.testing.assert_allclose(
        np.linalg.norm(cam2.cam_to_world[:3, 3]), 2.5, rtol=1e-6)
    ctl.process_scroll(-1e9)  # absurd zoom still >= 0.01 (camera.rs:80)
    cam3 = ctl.update_camera(cam2, dt=1.0)
    assert np.linalg.norm(cam3.cam_to_world[:3, 3]) >= 0.01 - 1e-9


def test_fps_translation_in_camera_frame():
    cam = _cam()  # at (0,0,5) looking toward -z (the origin)
    ctl = FirstPersonCameraController(move_sensitivity=1.0)
    assert ctl.process_key("w")
    cam2 = ctl.update_camera(cam, dt=1.0)
    np.testing.assert_allclose(cam2.cam_to_world[:3, 3], [0, 0, 4],
                               atol=1e-6)
    assert ctl.process_key("d")
    cam3 = ctl.update_camera(cam2, dt=1.0)
    np.testing.assert_allclose(cam3.cam_to_world[:3, 3], [1, 0, 4],
                               atol=1e-6)
    assert not ctl.process_key("z")  # unbound key


def test_fps_yaw_rotates_view():
    cam = _cam()
    ctl = FirstPersonCameraController(rotate_sensitivity=1.0)
    ctl.process_mouse(90.0, 0.0)
    cam2 = ctl.update_camera(cam, dt=1.0)
    fwd = -cam2.cam_to_world[:3, 2]
    r = cam2.cam_to_world[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
    assert abs(np.dot(fwd, [0, 0, -1])) < 0.1  # view turned ~90 deg


def _jax_cam(cam):
    from pathtracer_tpu.core.camera import Camera as JCamera
    return JCamera(**{k: getattr(cam, k) for k in
                      ("cam_to_world", "raster_to_camera", "resolution",
                       "dx_camera", "dy_camera")})


@pytest.mark.parametrize("kind", ["orbit", "fps"])
def test_controllers_match_jax(kind):
    """The same inputs (numpy, seed 3) through both packages' controllers
    give the same camera matrices, step after step."""
    from pathtracer_tpu.core import controller as jctl
    rng = np.random.default_rng(3)
    cam = _cam(eye=(0.3, 1.1, 4.0), center=(0.1, 0.2, 0.0))
    jcam = _jax_cam(cam)
    if kind == "orbit":
        pivot = rng.normal(size=3) * 0.1
        ctls = (OrbitalCameraController(pivot, 1.3, 0.7),
                jctl.OrbitalCameraController(pivot, 1.3, 0.7))
    else:
        ctls = (FirstPersonCameraController(0.8, 0.4),
                jctl.FirstPersonCameraController(0.8, 0.4))
    for _ in range(12):
        dx, dy = rng.normal(size=2) * 20.0
        scroll = float(rng.normal() * 0.3)
        key = "wasdqe "[int(rng.integers(7))]
        for c in ctls:
            c.process_mouse(dx, dy)
            if kind == "orbit":
                c.process_scroll(scroll)
            else:
                c.process_key(key)
        dt = float(rng.uniform(0.1, 1.0))
        cam = ctls[0].update_camera(cam, dt)
        jcam = ctls[1].update_camera(jcam, dt)
        assert isinstance(cam, Camera)
        np.testing.assert_allclose(cam.cam_to_world, jcam.cam_to_world,
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(cam.raster_to_camera,
                                      jcam.raster_to_camera)


def test_dispatch_key_bindings():
    cam = _cam()
    ctl = OrbitalCameraController(pivot=(0, 0, 0))
    st = ViewerState(camera=cam, spp=4, controller=ctl)
    st = dispatch_key(st, "]")
    assert st.spp == 8
    st = dispatch_key(st, "[")
    st = dispatch_key(st, "[")
    assert st.spp == 2
    st = dispatch_key(st, "h")
    assert st.dirty
    st = dispatch_key(st, "r")
    assert st.restart
    st = dispatch_key(st, "o")
    assert st.save
    st = dispatch_key(st, "\x1b")
    assert st.quit


def test_interactive_headless_frame(tmp_path, monkeypatch):
    """One bounded interactive frame renders and writes the PNG without a
    terminal or tev server."""
    monkeypatch.setattr("sys.stdin", open(os.devnull))
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(16, 16), device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=1), spp=1)
    out = str(tmp_path / "frame.png")
    film = run(cam, sd, integ, out, server_address="127.0.0.1:1",
               max_frames=1)
    assert film is not None
    assert bool(torch.isfinite(film).all()) and bool((film[..., 3] > 0).all())
    assert os.path.exists(out)


def test_preview_frame_shades_albedo():
    """preview_frame returns an albedo-shaded primary-visibility image:
    walls colored, background dim."""
    cam, ts = _cornell((24, 24))
    rgb = preview_frame(cam, ts)
    assert rgb.shape == (24, 24, 3)
    assert np.isfinite(rgb).all()
    mid = rgb[8:16]
    # red wall left of image, green wall right (albedo shading visible)
    assert mid[:, :6, 0].mean() > mid[:, :6, 1].mean()
    assert mid[:, -6:, 1].mean() > mid[:, -6:, 0].mean()


def test_dispatch_key_debug_bindings():
    cam = _cam()
    ctl = OrbitalCameraController(pivot=(0, 0, 0))
    st = ViewerState(camera=cam, spp=4, controller=ctl)
    st = dispatch_key(st, "m")
    assert st.wire and st.preview
    st.preview = False
    st = dispatch_key(st, "b")
    assert st.bounds and st.preview
    st = dispatch_key(st, "m")
    st = dispatch_key(st, "b")
    assert not st.wire and not st.bounds
    st = dispatch_key(st, "g")
    assert st.debug_pixel


def test_wireframe_overlay_marks_edges():
    cam, ts = _cornell((32, 32))
    plain = preview_frame(cam, ts)
    wired = preview_frame(cam, ts, wire=True)
    edge = np.all(np.abs(wired - [0.1, 1.0, 0.25]) < 1e-6, axis=-1)
    assert edge.sum() > 10          # edges drawn
    assert edge.sum() < edge.size / 2  # but not everywhere
    assert not np.allclose(plain, wired)


def test_bvh_bounds_overlay_draws_boxes():
    cam, ts = _cornell((48, 48), use_bvh=True)
    boxes = bvh_level_boxes(ts, levels=2)
    assert boxes, "forced BVH scene must yield level boxes"
    p = torch.cat([ts.data.p0, ts.data.p1, ts.data.p2]).numpy()
    lo, hi = p.min(0), p.max(0)
    for _lvl, bmin, bmax in boxes:
        assert (bmin >= lo - 1e-3).all() and (bmax <= hi + 1e-3).all()
        assert (bmax >= bmin).all()
    img = preview_frame(cam, ts)
    before = img.copy()
    out = draw_bvh_bounds(img, cam, ts, levels=2)
    assert not np.allclose(before, out)


def test_project_points_inverts_raygen():
    """project_points is the inverse of the generate_rays chain: a point
    along the ray through raster (x, y) projects back to (x, y)."""
    from pathtracer_tpu_torch.core.camera import generate_rays
    cam = _cam()
    pf = torch.tensor([[4.5, 7.25], [16.0, 16.0], [30.0, 2.0]])
    o, d = generate_rays(*cam.ray_params("cpu"), pf)
    pts = (o + 3.0 * d).numpy()
    xy, ok = project_points(cam, pts)
    assert ok.all()
    np.testing.assert_allclose(xy, pf.numpy(), atol=1e-3)


@pytest.fixture(scope="module")
def config_b():
    """Config B in both packages (the JAX scene's BVH32 table and the
    port's own, both from ``bvh_builder.cpp``)."""
    from pathtracer_tpu.integrator import TracedScene as JTracedScene
    from pathtracer_tpu.scene import procedural as jprocedural
    jcam, jsd = jprocedural.small_scene((40, 30))
    cam, sd = procedural.small_scene((40, 30), device="cpu")
    return cam, TracedScene.create(sd), jcam, JTracedScene.create(jsd)


def test_bvh_level_boxes_match_jax(config_b):
    from pathtracer_tpu.frontend.interactive import \
        bvh_level_boxes as jbvh_level_boxes
    _, ts, _, jts = config_b
    assert ts.bw_rows is not None
    got = bvh_level_boxes(ts, levels=3)
    want = jbvh_level_boxes(jts, levels=3)
    assert len(got) == len(want) > 1
    for (gl, gmin, gmax), (wl, wmin, wmax) in zip(got, want):
        assert gl == wl
        np.testing.assert_array_equal(gmin, wmin)
        np.testing.assert_array_equal(gmax, wmax)


@pytest.mark.slow
@pytest.mark.parametrize("wire", [False, True])
def test_preview_matches_jax_on_config_b(config_b, wire):
    from pathtracer_tpu.frontend.interactive import \
        preview_frame as jpreview_frame
    cam, ts, jcam, jts = config_b
    np.testing.assert_array_equal(cam.cam_to_world, jcam.cam_to_world)
    got = preview_frame(cam, ts, wire=wire)
    want = jpreview_frame(jcam, jts, wire=wire)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the overlay marks the same pixels
    marked = [np.any(draw_bvh_bounds(img.copy(), cam, ts) != img, axis=-1)
              for img in (got, want)]
    assert marked[0].any()
    np.testing.assert_array_equal(marked[0], marked[1])


@pytest.mark.slow
def test_preview_matches_jax_on_cornell():
    from pathtracer_tpu.frontend.interactive import \
        preview_frame as jpreview_frame
    from pathtracer_tpu.integrator import TracedScene as JTracedScene
    from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
    cam, ts = _cornell((24, 24))
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(24, 24))
    want = jpreview_frame(jcam, JTracedScene.create(jsd, use_pallas=False),
                          wire=True)
    np.testing.assert_allclose(preview_frame(cam, ts, wire=True), want,
                               rtol=0, atol=1e-5)
