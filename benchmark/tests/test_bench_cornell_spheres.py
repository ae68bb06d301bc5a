"""The ``cornell-spheres`` configuration and its cell, and the three
readers it brought (``bsdf_ops_per_ksample``, ``k2_roofline_pct``,
``live_lane_pct``) on synthetic events and counters: what each reads
from a program that has the span or counter, and None from one that
has not."""

import hashlib
import os
import types

import numpy as np
import pytest

from conftest import BENCH_DIR
from harness import links, manifest, spans

MAN = manifest.load_manifest()
CELL = "cornell-spheres-640-d15"
SPAN = (0, 10_000)


def metric(name):
    return manifest.load_metric(name)


# ------------------------------------------------ configuration and cell
def test_config_scene_hash_and_counts():
    from reference import mitsuba_scene, sphere_scene

    entry = manifest.cell(MAN, CELL)
    assert entry["config"] == "cornell-spheres" and entry["chips"] == 1
    assert entry["traffic"] == "viewer-d15"
    cfg = manifest.config(MAN, "cornell-spheres")
    with open(cfg["scene"]["path"], "rb") as fh:
        assert hashlib.sha256(fh.read()).hexdigest() == cfg["scene"]["sha256"]
    tris = sphere_scene.load(cfg["scene"]["path"])
    assert len(tris["p"]) == cfg["triangles"] == 552
    assert len(tris["light_tri"]) == cfg["lights"] == 2
    assert cfg["alpha_masked_triangles"] == 0
    assert sorted(set(tris["mtype"].tolist())) == [
        sphere_scene.MATTE, sphere_scene.METAL, sphere_scene.SUBSTRATE,
        sphere_scene.GLASS]
    p = tris["p"].reshape(-1, 3)
    diag = np.float32(np.linalg.norm(p.max(0) - p.min(0)))
    assert abs(cfg["bbox_diagonal"] - float(diag)) < 1e-6
    sensor = mitsuba_scene.sensor_camera(cfg["scene"]["path"])
    assert sensor["cam_to_world"] == cfg["camera"]["cam_to_world"]
    assert sensor["fovy"] == cfg["camera"]["fovy"]
    assert manifest.reference(cfg).__name__ == "reference.sphere_path"
    listed = next(c for c in MAN["configs"] if c["name"] == "cornell-spheres")
    assert listed["reduced"] == cfg["reduced"] == ["resolution"]
    assert listed["source"] == cfg["source"]


def test_traffic_is_the_preview_at_depth_15():
    d15 = manifest.traffic("viewer-d15")
    preview = manifest.traffic("viewer-preview")
    changed = {k for k in d15 if d15[k] != preview.get(k)}
    assert changed == {"what", "max_depth", "trace_passes"}
    assert d15["max_depth"] == 15 and d15["trace_passes"] == 1


def test_limits_hold_their_readings():
    lim = manifest.limits(CELL)
    for name in ("off_px_pct", "weight_rel_max", "mean_rel"):
        assert lim[name]["lower"] < lim[name]["limit"] < lim[name]["upper"]
    assert set(lim["readings"]) == {"lower", "upper"}


def test_the_cells_metrics():
    new = {"bsdf_ops_per_ksample", "k2_roofline_pct", "live_lane_pct"}
    got = {m["name"] for m in manifest.metrics_for(MAN, CELL, True)}
    assert new <= got
    cornell = {m["name"] for m in
               manifest.metrics_for(MAN, "cornell-640-preview", True)}
    assert cornell & new == {"live_lane_pct"}
    e2e = {m["name"] for m in manifest.metrics_for(MAN, CELL, False)}
    assert e2e == {"msamples_per_s", "setup_s"}
    for name in new:
        assert callable(metric(name).compute)


SMALL = dict(resolution=[32, 24], job_spp=4, pass_spp=2,
             check=dict(tiles=4, tile_px=8))
SEED = 2**31 + 21


def _small():
    entry = manifest.cell(MAN, CELL)
    return (manifest.config(MAN, entry["config"]),
            dict(manifest.traffic(entry["traffic"]), **SMALL),
            manifest.limits(CELL))


def test_sound_run_is_correct_on_the_cpu():
    """The cell through the harness at a small size (K2's plain
    traversal, the CPU's eager loop), under the cell's own limits."""
    from harness import runner

    cfg, traffic, limits = _small()
    result = runner.run_cell(cfg, traffic, limits,
                             manifest.metrics_for(MAN, CELL, False), SEED,
                             0.5, False, "cpu")
    assert result["correct"], result["check"]
    assert "msamples_per_s" in result["metrics"]


def test_control_fails_the_check():
    """The bfloat16 control in the program's place, at four frames."""
    import torch

    from harness import check, runner, workload

    cfg, traffic, limits = _small()
    view = workload.moved_camera(cfg, traffic, SEED)
    tiles = workload.check_tiles(SEED, traffic)
    ref = runner.reference_film(cfg, traffic, view, tiles, 4, "cpu")
    ctl = runner.reference_film(cfg, traffic, view, tiles, 4, "cpu",
                                control=torch.bfloat16)
    correct, _ = check.judge(check.compare(ctl, ref), limits)
    assert not correct
    assert np.isfinite(ref).all() and ref[..., :3].sum() > 0


# ----------------------------------------------------- synthetic events
def _events(k2_linked=True):
    """One band-frame's spans (100 ns units) with a BSDF branch in the
    light's branch and in the scatter, and two K2 launches; the runtime
    calls and device operations they issued."""
    sp = [("pt::band_frame", 100, 900), ("pt::bounce", 110, 800),
          ("pt::intersect", 120, 200), ("pt::k:bvhw", 130, 140),
          ("pt::nee", 300, 500), ("pt::bsdf:metal", 310, 350),
          ("pt::intersect", 400, 450), ("pt::k:bvhw", 410, 420),
          ("pt::scatter", 600, 780), ("pt::bsdf:glass", 610, 640),
          ("pt::bsdf:metal", 650, 700)]
    runtime, device = {}, []
    issued = [(135, "void (anonymous namespace)::bvhw_kernel<x>(y)", 10_000),
              (415, "void (anonymous namespace)::bvhw_kernel<x>(y)", 4_000),
              (320, "elementwise", 50), (330, "elementwise", 50),
              (620, "elementwise", 50), (660, "elementwise", 50),
              (670, "elementwise", 50), (550, "elementwise", 50),
              (150, "elementwise", 50)]
    for corr, (t, name, dur) in enumerate(issued, start=1):
        if k2_linked or "bvhw" not in name:
            runtime[corr] = t
        device.append((name, t + 5, t + 5 + dur, corr))
    return device, runtime, sp


def test_links_count_bsdf_ops_and_k2_time():
    device, runtime, sp = _events()
    got = links.summarise(device, runtime, sp, SPAN)
    assert got["bsdf_ops"] == 5 and got["bsdf_spans"] == 3
    assert got["k2_kernels"] == 2
    assert got["k2_s"] == pytest.approx(14_000e-9)
    # the layer rule is untouched: the branches count as shading
    chains = spans.chains(sp, [runtime[d[3]] for d in device])
    assert spans.layer_of(chains[2]) == "shading"
    assert spans.summarise(device, runtime, sp, SPAN)["ops"]["intersect"] \
        == 3


def test_links_k2_kernels_whose_launch_the_trace_lost():
    device, runtime, sp = _events(k2_linked=False)
    got = links.summarise(device, runtime, sp, SPAN)
    assert got["k2_kernels"] == 0 and got["k2_s"] == 0


def _record(extra, samples=4_000):
    return dict(trace=dict(samples=samples, extra=extra))


def test_bsdf_ops_per_ksample():
    device, runtime, sp = _events()
    rec = _record(dict(links=links.summarise(device, runtime, sp, SPAN)))
    assert metric("bsdf_ops_per_ksample").compute(rec) == pytest.approx(5 / 4)
    no_spans = [s for s in sp if not s[0].startswith("pt::bsdf:")]
    rec = _record(dict(links=links.summarise(device, runtime, no_spans,
                                             SPAN)))
    assert metric("bsdf_ops_per_ksample").compute(rec) is None
    assert metric("bsdf_ops_per_ksample").compute(_record({})) is None


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


def test_k2_roofline_reads_the_byte_count_across_replays(monkeypatch):
    """The bytes of the traced passes: a capture's tally counted once a
    replay, against the linked kernels' device time."""
    from pathtracer_tpu_torch.ops.cuda import _build, bvhw_cu

    monkeypatch.setattr(bvhw_cu, "BYTES", 5_000)
    reader = metric("k2_roofline_pct")
    tracer = _tracer()
    reader.attach(None, tracer)
    with _build.capturing() as tally:
        _build.count("bvhw.bytes", bvhw_cu.launch_bytes(35, 131072, False))
        _build.count("bvhw.bytes", bvhw_cu.launch_bytes(35, 131072, True))
    assert bvhw_cu.BYTES == 5_000

    def replays():
        for _ in range(12):
            _build.replayed(tally)
    _run(tracer, replays)
    moved = 12 * (131072 * 78 + 2 * 35 * 1024)
    assert tracer.extra["k2_roofline_pct"] == moved
    device, runtime, sp = _events()
    tracer.extra["links"] = links.summarise(device, runtime, sp, SPAN)
    got = reader.compute(_record(tracer.extra))
    assert got == pytest.approx(100.0 * moved / 3.35e12 / 14_000e-9)
    tracer.extra["links"]["k2_s"] = 0.0
    assert reader.compute(_record(tracer.extra)) is None


def test_k2_roofline_without_the_count_is_none(monkeypatch):
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu

    monkeypatch.delattr(bvhw_cu, "BYTES")
    reader = metric("k2_roofline_pct")
    tracer = _tracer()
    reader.attach(None, tracer)
    assert tracer.on_start == [] and tracer.on_stop == []
    device, runtime, sp = _events()
    tracer.extra["links"] = links.summarise(device, runtime, sp, SPAN)
    assert reader.compute(_record(tracer.extra)) is None


def test_live_lane_pct_reads_the_integrators_counters():
    counts = dict(live=100.0, run=400.0)
    program = types.SimpleNamespace(
        integ=types.SimpleNamespace(lane_bounces=counts))
    reader = metric("live_lane_pct")
    tracer = _tracer()
    reader.attach(program, tracer)

    def one_pass():
        counts["live"] += 300.0
        counts["run"] += 1_000.0
    _run(tracer, one_pass)
    assert reader.compute(_record(tracer.extra)) == pytest.approx(30.0)


@pytest.mark.parametrize("program", [
    None, types.SimpleNamespace(integ=types.SimpleNamespace()),
    types.SimpleNamespace(integ=types.SimpleNamespace(
        bounce_occupancy=np.zeros(6)))], ids=["none", "bare", "parent"])
def test_live_lane_pct_without_the_counters_is_none(program):
    reader = metric("live_lane_pct")
    tracer = _tracer()
    reader.attach(program, tracer)
    _run(tracer, lambda: None)
    assert tracer.on_start == []
    assert reader.compute(_record(tracer.extra)) is None
    assert reader.compute(dict(trace=None)) is None


def test_readers_are_listed_under_their_names():
    entries = {m["name"]: m for m in MAN["per_layer"]}
    for name in ("bsdf_ops_per_ksample", "k2_roofline_pct", "live_lane_pct"):
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           name + ".py"))
        assert entries[name]["moves"] == "msamples_per_s"
    assert entries["bsdf_ops_per_ksample"]["workloads"] == [CELL]
    assert entries["k2_roofline_pct"]["workloads"] == [CELL]
    assert "workloads" not in entries["live_lane_pct"]
