"""The ``sphereflake`` configuration and its cell, and the three readers
it brought (``k2_ns_per_ray``, ``light_ops_per_ksample``,
``tables_build_s``) on synthetic events and counters: what each reads
from a program that has the span or counter, and None from one that has
not."""

import hashlib
import json
import os
import sys
import types

import numpy as np
import pytest

from conftest import BENCH_DIR
from harness import light_links, links, manifest, spans

MAN = manifest.load_manifest()
CELL = "sphereflake-640-d15"
NEW = {"k2_ns_per_ray", "light_ops_per_ksample", "tables_build_s"}
SPAN = (0, 10_000)
SCENES = os.path.join(BENCH_DIR, "scenes")
if SCENES not in sys.path:
    sys.path.insert(0, SCENES)

import make_sphereflake as msf  # noqa: E402


def metric(name):
    return manifest.load_metric(name)


# ------------------------------------------------ configuration and cell
def test_config_hashes_and_counts():
    """The file is the one the configuration names, and its JSON holds
    what the configuration counts."""
    entry = manifest.cell(MAN, CELL)
    assert entry["config"] == "sphereflake" and entry["chips"] == 1
    assert entry["traffic"] == "viewer-d15"
    cfg = manifest.config(MAN, "sphereflake")
    with open(cfg["scene"]["path"], "rb") as fh:
        blob = fh.read()
    assert hashlib.sha256(blob).hexdigest() == cfg["scene"]["sha256"]
    assert cfg["scene"]["loader"] == "gltf"
    doc = json.loads(blob)
    per_mesh = [doc["accessors"][m["primitives"][0]["indices"]]["count"]
                // 3 for m in doc["meshes"]]
    used = [n["mesh"] for n in doc["nodes"] if "mesh" in n]
    assert used.count(0) == cfg["spheres"] == 7381
    assert sum(per_mesh[m] for m in used) == cfg["triangles"] == 1328582
    assert len(doc["extensions"]["KHR_lights_punctual"]["lights"]) == \
        cfg["lights"] == 3
    assert cfg["alpha_masked_triangles"] == 0
    assert manifest.reference(cfg).__name__ == "reference.flake_path"
    listed = next(c for c in MAN["configs"] if c["name"] == "sphereflake")
    assert listed["reduced"] == cfg["reduced"] == []
    assert listed["source"] == cfg["source"] and len(cfg["source"]) <= 200
    np.testing.assert_allclose(cfg["camera"]["cam_to_world"],
                               msf.camera_to_world())


def test_the_cells_metrics():
    """The three new readers where their ``workloads`` name them: K2's
    time a ray in the three cells that run K2, the light's ops and the
    tables' seconds in all four."""
    got = {m["name"] for m in manifest.metrics_for(MAN, CELL, True)}
    assert NEW <= got
    assert not got & {"bsdf_ops_per_ksample", "k2_roofline_pct",
                      "env_ops_per_ksample", "env_live_pct"}
    cornell = {m["name"] for m in
               manifest.metrics_for(MAN, "cornell-640-preview", True)}
    assert cornell & NEW == {"light_ops_per_ksample", "tables_build_s"}
    for other in ("cornell-spheres-640-d15", "tankfarm-spheres-640-d15"):
        names = {m["name"] for m in manifest.metrics_for(MAN, other, True)}
        assert NEW <= names
    e2e = {m["name"] for m in manifest.metrics_for(MAN, CELL, False)}
    assert e2e == {"msamples_per_s", "setup_s"}
    entries = {m["name"]: m for m in MAN["per_layer"]}
    for name in NEW:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           name + ".py"))
        assert callable(metric(name).compute)
    assert entries["k2_ns_per_ray"]["moves"] == "msamples_per_s"
    assert entries["light_ops_per_ksample"]["moves"] == "msamples_per_s"
    assert entries["tables_build_s"]["moves"] == "setup_s"
    assert entries["tables_build_s"]["layer"] == "scene and tables"


def test_limits_hold_their_readings():
    lim = manifest.limits(CELL)
    for name in ("off_px_pct", "weight_rel_max", "mean_rel"):
        assert lim[name]["lower"] < lim[name]["limit"] < lim[name]["upper"] \
            or lim[name]["lower"] == 0.0 < lim[name]["limit"]
    assert set(lim["readings"]) == {"lower", "upper"}


def test_control_fails_the_check(tmp_path):
    """The bfloat16 control in the program's place, at two frames, on
    the generator's size-factor-1 flake."""
    import torch

    from harness import check, runner, workload

    cfg = manifest.config(MAN, "sphereflake")
    cfg["scene"]["path"] = msf.write(str(tmp_path / "sf1.gltf"), 1)
    traffic = dict(manifest.traffic("viewer-d15"), resolution=[24, 16],
                   job_spp=2, pass_spp=2, check=dict(tiles=3, tile_px=8))
    seed = 2**31 + 27
    view = workload.moved_camera(cfg, traffic, seed)
    tiles = workload.check_tiles(seed, traffic)
    ref = runner.reference_film(cfg, traffic, view, tiles, 2, "cpu")
    ctl = runner.reference_film(cfg, traffic, view, tiles, 2, "cpu",
                                control=torch.bfloat16)
    correct, _ = check.judge(check.compare(ctl, ref), manifest.limits(CELL))
    assert not correct
    assert np.isfinite(ref).all() and ref[..., :3].sum() > 0


# ----------------------------------------------------- synthetic events
def _events():
    """One band-frame's spans (ns): a light sample in ``pt::nee``, a
    light density in ``pt::shade``, two K2 launches; the runtime calls
    and device operations they issued."""
    sp = [("pt::band_frame", 100, 900), ("pt::bounce", 110, 800),
          ("pt::intersect", 120, 200), ("pt::k:bvhw", 130, 140),
          ("pt::shade", 210, 290), ("pt::light", 220, 240),
          ("pt::nee", 300, 500), ("pt::light", 310, 350),
          ("pt::intersect", 400, 450), ("pt::k:bvhw", 410, 420),
          ("pt::scatter", 600, 780)]
    issued = [(135, "void (anonymous namespace)::bvhw_kernel<x>(y)", 1_000),
              (225, "elementwise", 40), (230, "gather", 60),
              (320, "elementwise", 30), (330, "where", 20),
              (360, "elementwise", 50),
              (415, "void (anonymous namespace)::bvhw_kernel<x>(y)", 3_000),
              (650, "elementwise", 50)]
    runtime, device = {}, []
    for corr, (t, name, dur) in enumerate(issued, start=1):
        runtime[corr] = t
        device.append((name, t + 5, t + 5 + dur, corr))
    return device, runtime, sp


def _record(extra, samples=4_000, busy_s=1e-6):
    return dict(trace=dict(samples=samples, busy_s=busy_s, extra=extra))


def test_light_links_count_the_lights_ops_and_time():
    device, runtime, sp = _events()
    got = light_links.summarise(device, runtime, sp, SPAN)
    assert got["light_ops"] == 4 and got["light_spans"] == 2
    assert got["light_s"] == pytest.approx(150e-9)
    # ``pt::light`` names no layer: its ops count in the layer around it
    ops = spans.summarise(device, runtime, sp, SPAN)["ops"]
    assert ops["shading"] == 6 and ops["intersect"] == 2


def test_light_ops_per_ksample(capsys):
    device, runtime, sp = _events()
    rec = _record(dict(light_links=light_links.summarise(device, runtime,
                                                         sp, SPAN)))
    assert metric("light_ops_per_ksample").compute(rec) == \
        pytest.approx(1.0)
    assert "15.00 % of the traced busy time" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    {}, dict(light_links=None),
    dict(light_links=dict(light_ops=0, light_s=0.0, light_spans=0))],
    ids=["no_reader", "no_pass", "no_span"])
def test_light_ops_per_ksample_without_the_span_is_none(extra):
    assert metric("light_ops_per_ksample").compute(_record(extra)) is None
    assert metric("light_ops_per_ksample").compute(dict(trace=None)) is None


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


def test_k2_ns_per_ray_reads_the_kernels_and_the_lanes(monkeypatch):
    """The K2 kernels' device time linked to ``pt::k:bvhw`` over the
    lanes ``bvhw_cu.RAYS`` moved by in the traced passes."""
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu

    monkeypatch.setattr(bvhw_cu, "RAYS", 1_000)
    reader = metric("k2_ns_per_ray")
    tracer = _tracer()
    reader.attach(None, tracer)
    _run(tracer, lambda: monkeypatch.setattr(bvhw_cu, "RAYS", 5_000))
    device, runtime, sp = _events()
    extra = dict(tracer.extra, links=links.summarise(device, runtime, sp,
                                                     SPAN))
    assert extra["links"]["k2_kernels"] == 2
    # 4,000 ns of K2 over 4,000 lanes
    assert reader.compute(_record(extra)) == pytest.approx(1.0)


def test_k2_ns_per_ray_without_the_count_is_none(monkeypatch):
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu

    monkeypatch.delattr(bvhw_cu, "RAYS")
    reader = metric("k2_ns_per_ray")
    tracer = _tracer()
    reader.attach(None, tracer)
    assert tracer.on_start == []
    device, runtime, sp = _events()
    extra = dict(tracer.extra, links=links.summarise(device, runtime, sp,
                                                     SPAN))
    assert reader.compute(_record(extra)) is None
    assert reader.compute(_record({})) is None
    assert reader.compute(dict(trace=None)) is None


def test_tables_build_s_reads_the_counter(monkeypatch):
    from pathtracer_tpu_torch import integrator

    monkeypatch.setattr(integrator, "TABLES_S", 3.25)
    reader = metric("tables_build_s")
    tracer = _tracer()
    reader.attach(None, tracer)
    _run(tracer, lambda: None)
    assert reader.compute(_record(tracer.extra)) == 3.25


@pytest.mark.parametrize("value", [None, 0.0], ids=["parent", "unset"])
def test_tables_build_s_without_the_counter_is_none(monkeypatch, value):
    from pathtracer_tpu_torch import integrator

    if value is None:
        monkeypatch.delattr(integrator, "TABLES_S")
    else:
        monkeypatch.setattr(integrator, "TABLES_S", value)
    reader = metric("tables_build_s")
    tracer = _tracer()
    reader.attach(None, tracer)
    assert reader.compute(_record(tracer.extra)) is None
    assert reader.compute(dict(trace=None)) is None
