"""The ``tankfarm-spheres`` configuration and its cell, and the two readers
it brought (``env_ops_per_ksample``, ``env_live_pct``) on synthetic
events and counters: what each reads from a program that has the span or
counter, and None from one that has not."""

import hashlib
import os
import types

import numpy as np
import pytest

from conftest import BENCH_DIR
from harness import env_links, manifest, spans

MAN = manifest.load_manifest()
CELL = "tankfarm-spheres-640-d15"
NEW = {"env_ops_per_ksample", "env_live_pct"}
SPAN = (0, 10_000)


def metric(name):
    return manifest.load_metric(name)


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


# ------------------------------------------------ configuration and cell
def test_config_hashes_and_counts():
    from reference import env_scene, mitsuba_scene

    entry = manifest.cell(MAN, CELL)
    assert entry["config"] == "tankfarm-spheres" and entry["chips"] == 1
    assert entry["traffic"] == "viewer-d15"
    cfg = manifest.config(MAN, "tankfarm-spheres")
    assert _sha(cfg["scene"]["path"]) == cfg["scene"]["sha256"]
    tris = env_scene.load(cfg["scene"]["path"])
    env = cfg["scene"]["environment"]
    hdr = os.path.join(os.path.dirname(cfg["scene"]["path"]), env["file"])
    assert os.path.samefile(hdr, tris["env"]["path"])
    assert _sha(hdr) == env["sha256"]
    assert len(tris["p"]) == cfg["triangles"] == 722
    assert len(tris["light_tri"]) == 0 and cfg["lights"] == 1
    assert cfg["alpha_masked_triangles"] == 0
    assert sorted(set(tris["mtype"].tolist())) == [0, 1, 2, 4, 5]
    p = tris["p"].reshape(-1, 3)
    diag = np.float32(np.linalg.norm(p.max(0) - p.min(0)))
    assert abs(cfg["bbox_diagonal"] - float(diag)) < 1e-6
    sensor = mitsuba_scene.sensor_camera(cfg["scene"]["path"])
    assert sensor["cam_to_world"] == cfg["camera"]["cam_to_world"]
    assert sensor["fovy"] == cfg["camera"]["fovy"]
    assert manifest.reference(cfg).__name__ == "reference.env_path"
    listed = next(c for c in MAN["configs"]
                  if c["name"] == "tankfarm-spheres")
    assert listed["reduced"] == cfg["reduced"] == []
    assert listed["source"] == cfg["source"]


def test_the_cells_metrics():
    """The new readers in the new cell alone; the cell reports every
    per-layer metric without a ``workloads`` list and none of those whose
    list names only the spheres."""
    got = {m["name"] for m in manifest.metrics_for(MAN, CELL, True)}
    unlisted = {m["name"] for m in MAN["per_layer"] if "workloads" not in m}
    assert got == unlisted | NEW
    assert not got & {"bsdf_ops_per_ksample", "k2_roofline_pct"}
    for other in ("cornell-640-preview", "cornell-spheres-640-d15"):
        names = {m["name"] for m in manifest.metrics_for(MAN, other, True)}
        assert not names & NEW
    e2e = {m["name"] for m in manifest.metrics_for(MAN, CELL, False)}
    assert e2e == {"msamples_per_s", "setup_s"}
    entries = {m["name"]: m for m in MAN["per_layer"]}
    for name in NEW:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           name + ".py"))
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "msamples_per_s"
        assert entries[name]["layer"] == \
            "environment light: ops/lights.py env_*"
        assert callable(metric(name).compute)


def test_limits_hold_their_readings():
    lim = manifest.limits(CELL)
    for name in ("off_px_pct", "weight_rel_max", "mean_rel"):
        assert lim[name]["lower"] < lim[name]["limit"] < lim[name]["upper"]
    assert set(lim["readings"]) == {"lower", "upper"}


SMALL = dict(resolution=[24, 16], job_spp=2, pass_spp=2,
             check=dict(tiles=3, tile_px=8))
SEED = 2**31 + 25


def _small():
    entry = manifest.cell(MAN, CELL)
    return (manifest.config(MAN, entry["config"]),
            dict(manifest.traffic(entry["traffic"]), **SMALL),
            manifest.limits(CELL))


def test_reference_film_repeats_for_a_seed():
    """The reference's film at a tiny size is the same bits for the same
    seed's view and tiles, and another seed's differs."""
    from harness import runner, workload

    cfg, traffic, _ = _small()

    def film(seed):
        return runner.reference_film(
            cfg, traffic, workload.moved_camera(cfg, traffic, seed),
            workload.check_tiles(seed, traffic), 2, "cpu")

    first = film(SEED)
    assert np.array_equal(first, film(SEED))
    assert np.isfinite(first).all() and first[..., :3].sum() > 0
    assert not np.array_equal(first, film(SEED + 1))


def test_control_fails_the_check():
    """The bfloat16 control in the program's place, at two frames."""
    import torch

    from harness import check, runner, workload

    cfg, traffic, limits = _small()
    view = workload.moved_camera(cfg, traffic, SEED)
    tiles = workload.check_tiles(SEED, traffic)
    ref = runner.reference_film(cfg, traffic, view, tiles, 2, "cpu")
    ctl = runner.reference_film(cfg, traffic, view, tiles, 2, "cpu",
                                control=torch.bfloat16)
    correct, _ = check.judge(check.compare(ctl, ref), limits)
    assert not correct


# ----------------------------------------------------- synthetic events
def _events():
    """One band-frame's spans (ns): the escape's two
    environment calls in ``pt::shade``, the light's sample in ``pt::nee``;
    the runtime calls and device operations they issued."""
    sp = [("pt::band_frame", 100, 900), ("pt::bounce", 110, 800),
          ("pt::intersect", 120, 200), ("pt::k:bvhw", 130, 140),
          ("pt::shade", 210, 290), ("pt::env", 220, 240),
          ("pt::env", 250, 260), ("pt::nee", 300, 500),
          ("pt::env", 310, 350), ("pt::scatter", 600, 780)]
    issued = [(135, "void (anonymous namespace)::bvhw_kernel<x>(y)", 1_000),
              (225, "elementwise", 40), (230, "gather", 60),
              (255, "elementwise", 30), (270, "where", 20),
              (320, "searchsorted", 90), (360, "elementwise", 50),
              (650, "elementwise", 50)]
    runtime, device = {}, []
    for corr, (t, name, dur) in enumerate(issued, start=1):
        runtime[corr] = t
        device.append((name, t + 5, t + 5 + dur, corr))
    return device, runtime, sp


def _record(extra, samples=4_000, busy_s=2e-6):
    return dict(trace=dict(samples=samples, busy_s=busy_s, extra=extra))


def test_env_links_count_the_environments_ops_and_time():
    device, runtime, sp = _events()
    got = env_links.summarise(device, runtime, sp, SPAN)
    assert got["env_ops"] == 4 and got["env_spans"] == 3
    assert got["env_s"] == pytest.approx(220e-9)
    # ``pt::env`` names no layer: its ops count in the layer around it
    ops = spans.summarise(device, runtime, sp, SPAN)["ops"]
    assert ops["shading"] == 7 and ops["intersect"] == 1


def test_env_ops_per_ksample(capsys):
    device, runtime, sp = _events()
    rec = _record(dict(env_links=env_links.summarise(device, runtime, sp,
                                                     SPAN)))
    assert metric("env_ops_per_ksample").compute(rec) == pytest.approx(1.0)
    assert "11.00 % of the traced busy time" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    {}, dict(env_links=None),
    dict(env_links=dict(env_ops=0, env_s=0.0, env_spans=0))],
    ids=["no_reader", "no_pass", "no_span"])
def test_env_ops_per_ksample_without_the_span_is_none(extra):
    assert metric("env_ops_per_ksample").compute(_record(extra)) is None
    assert metric("env_ops_per_ksample").compute(dict(trace=None)) is None


def _tracer():
    return types.SimpleNamespace(on_start=[], on_stop=[], on_close=[],
                                 extra={}, prof=None, done=False)


def _run(tracer, between):
    for fn in tracer.on_start:
        fn()
    between()
    for fn in tracer.on_stop:
        fn()
    for fn in tracer.on_close:
        fn()


def test_env_live_pct_reads_the_integrators_counters():
    counts = dict(used=50.0, run=400.0)
    program = types.SimpleNamespace(
        integ=types.SimpleNamespace(env_lanes=counts))
    reader = metric("env_live_pct")
    tracer = _tracer()
    reader.attach(program, tracer)

    def one_pass():
        counts["used"] += 60.0
        counts["run"] += 1_000.0
    _run(tracer, one_pass)
    assert reader.compute(_record(tracer.extra)) == pytest.approx(6.0)


@pytest.mark.parametrize("program", [
    None, types.SimpleNamespace(integ=types.SimpleNamespace()),
    types.SimpleNamespace(integ=types.SimpleNamespace(
        lane_bounces=dict(live=1.0, run=2.0)))],
    ids=["none", "bare", "parent"])
def test_env_live_pct_without_the_counter_is_none(program):
    reader = metric("env_live_pct")
    tracer = _tracer()
    reader.attach(program, tracer)
    _run(tracer, lambda: None)
    assert tracer.on_start == []
    assert reader.compute(_record(tracer.extra)) is None
    assert reader.compute(dict(trace=None)) is None


def test_env_live_pct_where_the_environment_ran_on_no_lane_is_none():
    counts = dict(used=0.0, run=0.0)
    program = types.SimpleNamespace(
        integ=types.SimpleNamespace(env_lanes=counts))
    reader = metric("env_live_pct")
    tracer = _tracer()
    reader.attach(program, tracer)
    _run(tracer, lambda: None)
    assert reader.compute(_record(tracer.extra)) is None
