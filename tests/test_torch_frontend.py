"""The port's frontends against the JAX package's: the tev wire protocol,
the command line's flags, the headless runner, the single-pixel debug
trace, the CLI's light-tracer, profile, single-pixel and mesh paths, and
the loggers' allowlist and level cycle.

Films are held to the cornell golden's bar (RMSE < 1e-3 on RGB, alpha to
rtol 1e-5); the single pixel's samples to rtol 1e-4 / atol 1e-6 of the
JAX package's.
"""

import json
import logging
import os
import struct

import numpy as np
import pytest
import torch

from pathtracer_tpu.frontend import cli as jcli
from pathtracer_tpu.frontend import tev as jtev
from pathtracer_tpu.utils import logging as jlogging
from pathtracer_tpu_torch.core.film import to_rgb8
from pathtracer_tpu_torch.frontend import cli, headless, tev
from pathtracer_tpu_torch.frontend.debug import render_single_pixel
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.integrator_lt import LightTracer
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.utils import logging as plogging
from pathtracer_tpu_torch.utils.image import read_png

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")
GOLDEN = os.path.join(ROOT, "tests", "golden_cornell_32.npz")
# a port no tev server listens on: the runners fall back to no preview
NO_TEV = "127.0.0.1:1"


def _assert_film_close(got, want):
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2))
    assert rmse < 1e-3, rmse


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append((record.name, record.getMessage()))


@pytest.fixture
def records():
    """The messages logged under the "pathtracer" root while a test
    runs."""
    handler = _Records()
    root = logging.getLogger(plogging.ROOT)
    root.addHandler(handler)
    yield handler.messages
    root.removeHandler(handler)


@pytest.fixture(scope="module")
def cornell32():
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(32, 32), device="cpu")
    return cam, TracedScene.create(sd)


@pytest.mark.parametrize("shape", [(4, 4), (130, 120), (100, 201)])
def test_tev_packets_equal_the_jax_packages(shape):
    rgb = np.random.default_rng(7).random(shape + (3,), np.float32)
    assert tev.create_image_packet(shape[1], shape[0], "render") == \
        jtev.create_image_packet(shape[1], shape[0], "render")
    got = tev.update_image_packets(rgb, "frame")
    want = jtev.update_image_packets(rgb, "frame")
    assert got == want
    (length,) = struct.unpack("<i", got[0][:4])
    assert length == len(got[0])


_EVERY_FLAG = ["s.glb", "-o", "o", "-s", "16", "-r", "320x240", "-d", "7",
               "-l", "DEBUG", "-m", "scene,bvh", "--default_lights",
               "--headless", "--interactive", "fps", "--server", "h:1",
               "--mesh", "4", "--checkpoint", "ck", "--single_pixel", "3,4",
               "--chunk_spp", "2", "--filter", "lanczos", "--mis",
               "onesample", "--lighttrace", "1000", "--profile", "prof"]


@pytest.mark.parametrize("argv", [["scene.xml", "-o", "out"],
                                  ["scene.xml", "-o", "out",
                                   "--interactive"],
                                  _EVERY_FLAG])
def test_parser_gives_the_references_values(argv):
    want = vars(jcli.build_parser().parse_args(argv))
    got = vars(cli.build_parser().parse_args(argv))
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"
    assert cli.parse_resolution("640,480") == \
        jcli.parse_resolution("640,480") == (640, 480)
    assert cli.DEFAULT_RESOLUTION == jcli.DEFAULT_RESOLUTION
    assert cli.MAX_DEPTH == jcli.MAX_DEPTH


def test_headless_run_matches_golden_and_writes_its_film(tmp_path,
                                                         cornell32):
    cam, scene = cornell32
    integ = PathIntegrator(PathConfig(max_depth=3), spp=2)
    film = headless.run(cam, scene, integ, str(tmp_path),
                        server_address=NO_TEV)
    assert film.shape == (32, 32, 4)
    _assert_film_close(film.numpy(), np.load(GOLDEN)["film"])
    png = read_png(str(tmp_path / "render.png"))
    np.testing.assert_array_equal(png[..., :3], to_rgb8(film))


def test_headless_checkpoint_resume(tmp_path):
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(16, 16), device="cpu")
    ck = str(tmp_path / "ck.npz")
    cfg = PathConfig(max_depth=2)
    f_direct = PathIntegrator(cfg, spp=4).render(cam, sd)
    out = str(tmp_path / "out.png")
    f_chunk = headless.run(cam, sd, PathIntegrator(cfg, spp=4), out,
                           server_address=NO_TEV, chunk_spp=2, checkpoint=ck)
    np.testing.assert_allclose(f_direct.numpy(), f_chunk.numpy(), atol=2e-5)
    # resume from a completed checkpoint: no work, same result
    integ2 = PathIntegrator(cfg, spp=4)
    f_resume = headless.run(cam, sd, integ2, out, server_address=NO_TEV,
                            chunk_spp=2, checkpoint=ck)
    assert torch.equal(f_chunk, f_resume)
    assert integ2.last_ray_count == 0.0


@pytest.mark.slow
def test_single_pixel_matches_jax_per_sample(cornell32):
    from pathtracer_tpu.frontend.debug import \
        render_single_pixel as jrender_single_pixel
    from pathtracer_tpu.integrator import PathConfig as JPathConfig
    from pathtracer_tpu.integrator import TracedScene as JTracedScene
    from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
    cam, scene = cornell32
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(32, 32))
    for pixel, spp in (((16, 16), 4), ((3, 27), 3)):
        got = render_single_pixel(cam, scene, PathConfig(max_depth=3),
                                  pixel, spp)
        want = np.asarray(jrender_single_pixel(
            jcam, JTracedScene.create(jsd), JPathConfig(max_depth=3), pixel,
            spp))
        assert got.shape == want.shape == (4, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("route", ["brute force", "bvh"])
def test_single_pixel_on_both_routes(route):
    """spp rounds up to a power of two; on cornell (brute force) and config
    B (the BVH32 table) the samples are finite, not all zero, and the same
    on a second trace."""
    from pathtracer_tpu_torch.scene import procedural
    if route == "bvh":
        cam, sd = procedural.small_scene((24, 16), device="cpu")
    else:
        cam, sd, _ = load_mitsuba(CORNELL, resolution=(24, 16),
                                  device="cpu")
    scene = TracedScene.create(sd)
    assert scene.use_bvh == (route == "bvh")
    cfg = PathConfig(max_depth=2)
    rad = render_single_pixel(cam, scene, cfg, (12, 13), 3)
    assert rad.shape == (4, 3) and bool(torch.isfinite(rad).all())
    assert float(rad.sum()) > 0
    assert torch.equal(rad, render_single_pixel(cam, scene, cfg, (12, 13), 3))


def _cli(tmp_path, *extra, out="out.png", res="32x32", spp="2", depth="3"):
    argv = [CORNELL, "-o", str(tmp_path / out), "-r", res, "-s", spp, "-d",
            depth, "--device", "cpu", *extra]
    assert cli.main(argv) == 0
    return str(tmp_path / out)


def test_cli_lighttrace(tmp_path, cornell32):
    png = read_png(_cli(tmp_path, "--lighttrace", "4096", depth="1"))
    cam, scene = cornell32
    film = LightTracer(PathConfig(max_depth=1), paths=4096).render(cam, scene)
    np.testing.assert_array_equal(png[..., :3], to_rgb8(film))


def test_cli_profile_writes_a_trace_and_logs_occupancy(tmp_path, cornell32,
                                                      records):
    png = read_png(_cli(tmp_path, "--profile", str(tmp_path / "prof")))
    with open(tmp_path / "prof" / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]
    cam, scene = cornell32
    integ = PathIntegrator(PathConfig(max_depth=3), spp=2)
    film = integ.render(cam, scene)
    np.testing.assert_array_equal(png[..., :3], to_rgb8(film))
    lines = [m for name, m in records
             if name == "pathtracer.cli" and m.startswith("bounce")]
    assert len(lines) == 4
    logged = [float(m.split(":")[1].split()[0]) for m in lines]
    assert logged == integ.bounce_occupancy.tolist()
    # bounce 0: every camera lane of the 36 x 36 sample rectangle, 2 spp
    assert logged[0] == 36 * 36 * 2


def test_cli_single_pixel_logs_the_mean(tmp_path, cornell32, records):
    _cli(tmp_path, "--single_pixel", "16,16", spp="4")
    cam, scene = cornell32
    rad = render_single_pixel(cam, scene, PathConfig(max_depth=3), (16, 16),
                              4)
    means = [m for _, m in records if m.startswith("mean L")]
    assert means[0] == means[1]
    assert means[1].startswith(f"mean L = {rad.mean(0).tolist()}")
    assert not os.path.exists(tmp_path / "out.png")


def test_cli_binds_sigusr1_to_the_level_switch(tmp_path, records):
    """As the reference's CLI does, SIGUSR1 cycles INFO <-> DEBUG."""
    import signal
    root = logging.getLogger(plogging.ROOT)
    previous = signal.getsignal(signal.SIGUSR1)
    try:
        _cli(tmp_path, "--single_pixel", "1,1", spp="1")
        assert root.level == logging.INFO
        os.kill(os.getpid(), signal.SIGUSR1)
        assert root.level == logging.DEBUG
        os.kill(os.getpid(), signal.SIGUSR1)
        assert root.level == logging.INFO
        assert [m for name, m in records if name == "pathtracer"][-2:] \
            == ["log level switched to DEBUG",
                "log level switched to INFO"]
    finally:
        signal.signal(signal.SIGUSR1, previous)


@pytest.mark.parametrize("flag", ["--profile", "--checkpoint"])
def test_cli_refuses_mesh_with_profile_or_checkpoint(tmp_path, flag):
    """The reference's --mesh branch ignores --profile and --checkpoint;
    the port refuses the pair before it loads or spawns anything."""
    with pytest.raises(SystemExit) as exc:
        cli.main([CORNELL, "-o", str(tmp_path / "out.png"), "--mesh", "2",
                  flag, str(tmp_path / "x"), "--device", "cpu"])
    assert exc.value.code == 2
    assert not os.listdir(tmp_path)


def test_cli_single_pixel_takes_precedence_over_mesh(tmp_path, records):
    """As in the reference, --single_pixel runs before --mesh is read."""
    _cli(tmp_path, "--single_pixel", "16,16", "--mesh", "2", res="32x32")
    assert any(m.startswith("mean L") for _, m in records)
    assert not os.path.exists(tmp_path / "out.png")


def test_cli_mesh_on_two_cpu_ranks(tmp_path, cornell32):
    png = read_png(_cli(tmp_path, "--mesh", "2", res="24x20"))
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(24, 20), device="cpu")
    film = PathIntegrator(PathConfig(max_depth=3), spp=2).render(cam, sd)
    diff = np.abs(png[..., :3].astype(int) - to_rgb8(film).astype(int))
    # the same samples; only the film's sums run in another order
    assert diff.max() <= 1


_RECORDS = [("pathtracer.scene", logging.INFO),
            ("pathtracer.bvh", logging.INFO),
            ("pathtracer.bvh", logging.WARNING),
            ("pathtracer.viewer", logging.DEBUG),
            ("pathtracer.integrator", logging.ERROR)]


@pytest.mark.parametrize("allowed", [None, {"scene"}, {"bvh", "viewer"},
                                     set()])
def test_logging_allowlist_matches_jax(allowed):
    got = plogging.ModuleAllowlistFilter(allowed)
    want = jlogging.ModuleAllowlistFilter(allowed)
    for name, level in _RECORDS:
        rec = logging.LogRecord(name, level, __file__, 1, "m", None, None)
        assert got.filter(rec) == want.filter(rec)
    rec = logging.LogRecord("pathtracer.bvh", logging.INFO, __file__, 1,
                            "m", None, None)
    assert got.filter(rec) == (allowed is None or "bvh" in allowed)


def test_logging_level_cycle_matches_jax():
    root = logging.getLogger(plogging.ROOT)
    level = root.level
    try:
        assert plogging.ROOT == jlogging.ROOT == "pathtracer"
        assert plogging.MODULES == jlogging.MODULES
        plogging.init_logging("info", {"scene"})
        assert root.level == logging.INFO
        seen = [plogging.cycle_level(), plogging.cycle_level()]
        jlogging.set_level("INFO")
        assert seen == [jlogging.cycle_level(), jlogging.cycle_level()] \
            == ["DEBUG", "INFO"]
        plogging.set_level("warning")
        assert root.level == logging.WARNING
        assert plogging.get_logger("viewer").name == "pathtracer.viewer"
    finally:
        root.setLevel(level)
