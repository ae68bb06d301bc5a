"""The seeded camera move stays within the traffic's ranges, repeats for
a seed, and starts from the camera the scene file carries."""

import numpy as np
import pytest

from harness import manifest, workload

MAN = manifest.load_manifest()
SEEDS = [0, 1, 7, 2**31 + 5, 2**33 + 17, -3]


def _cells():
    for c in MAN["workloads"]:
        yield c["name"], manifest.config(MAN, c["config"]), \
            manifest.traffic(c["traffic"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [c["name"] for c in MAN["workloads"]])
def test_move_within_ranges(cell, seed):
    entry = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    cam = workload.moved_camera(cfg, traffic, seed)
    move = traffic["camera_move"]
    pub = np.asarray(cfg["camera"]["cam_to_world"])
    new = np.asarray(cam["cam_to_world"])
    # a rotation, moved by at most the yaw and pitch together
    r = new[:3, :3]
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-12)
    rel = r @ pub[:3, :3].T
    angle = np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))
    assert angle <= np.hypot(move["yaw_deg"], move["pitch_deg"]) + 1e-9
    assert abs(cam["move"]["yaw_deg"]) <= move["yaw_deg"]
    assert abs(cam["move"]["pitch_deg"]) <= move["pitch_deg"]
    shift = np.linalg.norm(new[:3, 3] - pub[:3, 3])
    assert shift <= move["eye_frac"] * cfg["bbox_diagonal"] * (1 + 1e-12)
    assert cam["fovy"] == cfg["camera"]["fovy"]
    # the same seed, the same camera; another seed, another camera
    assert workload.moved_camera(cfg, traffic, seed) == cam
    assert workload.moved_camera(cfg, traffic, seed + 1)["cam_to_world"] \
        != cam["cam_to_world"]


@pytest.mark.parametrize("seed", SEEDS)
def test_tiles_inside_the_image(seed):
    for _, _, traffic in _cells():
        tiles = workload.check_tiles(seed, traffic)
        w, h = traffic["resolution"]
        size = traffic["check"]["tile_px"]
        assert len(tiles) == traffic["check"]["tiles"]
        assert all(0 <= x <= w - size and 0 <= y <= h - size
                   for x, y in tiles)
        assert tiles == workload.check_tiles(seed, traffic)


@pytest.mark.parametrize("job", [1, 2, 40])
def test_each_job_moves_anew(job):
    """Each job's view is a draw of its own, within the same ranges."""
    for _, cfg, traffic in _cells():
        first = workload.moved_camera(cfg, traffic, 5)
        cam = workload.moved_camera(cfg, traffic, 5, job)
        assert cam["cam_to_world"] != first["cam_to_world"]
        assert cam == workload.moved_camera(cfg, traffic, 5, job)
        assert abs(cam["move"]["yaw_deg"]) <= traffic["camera_move"][
            "yaw_deg"]


@pytest.mark.parametrize("cell", [c["name"] for c in MAN["workloads"]])
def test_published_camera_is_the_files(cell):
    """The configuration's camera numbers are the scene file's sensor, as
    the reference reads it, and make the camera the port's importer
    makes of the file."""
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
    from harness.program import Program

    from reference import mitsuba_scene

    entry = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    sensor = mitsuba_scene.sensor_camera(cfg["scene"]["path"])
    assert np.allclose(sensor["cam_to_world"], cfg["camera"]["cam_to_world"],
                       atol=1e-12)
    assert sensor["fovy"] == pytest.approx(cfg["camera"]["fovy"], rel=1e-15)
    res = tuple(traffic["resolution"])
    cam_file, _, _ = load_mitsuba(cfg["scene"]["path"], resolution=res,
                                  device="cpu")
    cam = Program.camera(type("P", (), {"resolution": res})(), cfg["camera"])
    assert np.allclose(cam.cam_to_world, cam_file.cam_to_world, atol=1e-12)
    assert np.allclose(cam.raster_to_camera, cam_file.raster_to_camera,
                       rtol=1e-12, atol=1e-12)
