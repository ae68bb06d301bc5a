"""BENCHMARK.json and the files it names: every name resolves to a file
of its own, and a new configuration, traffic mix or metric is taken in
as a new file and a new entry, with no existing file edited."""

import json
import os
import shutil

import pytest

from conftest import BENCH_DIR, ROOT_DIR
from harness import manifest

MAN = manifest.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(MAN) == TOP_KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]


@pytest.mark.parametrize("cell", [c["name"] for c in MAN["workloads"]])
def test_cell_files_resolve(cell):
    entry = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, entry["config"])
    assert os.path.exists(cfg["scene"]["path"])
    traffic = manifest.traffic(entry["traffic"])
    w, h = traffic["resolution"]
    assert traffic["check"]["tile_px"] <= min(w, h)
    limits = manifest.limits(cell)
    from harness.check import NUMBERS
    assert set(NUMBERS) <= set(limits)
    for trace in (False, True):
        for m in manifest.metrics_for(MAN, cell, trace):
            assert hasattr(manifest.load_metric(m["name"]), "compute")
    assert hasattr(manifest.reference(cfg), "render_tiles")


def test_every_metric_has_a_reader():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_metrics_for_follows_workloads():
    # a cell that a metric's ``workloads`` does not list leaves it out
    names = {m["name"] for m in manifest.metrics_for(MAN, "another-cell",
                                                     False)}
    assert names == {"msamples_per_s", "setup_s"}
    names = {m["name"] for m in manifest.metrics_for(
        MAN, "cornell-640-preview", False)}
    assert names == {"msamples_per_s", "pass_ms_p50", "setup_s"}
    layer = {m["name"] for m in manifest.metrics_for(
        MAN, "cornell-640-preview", True)}
    assert layer == {"device_ops_per_ksample", "device_idle_pct",
                     "peak_mem_mib"}


def test_new_files_are_found_by_name(tmp_path):
    """A throwaway configuration, traffic mix, limits and metric, dropped
    into a copy of the folder as new files, with new manifest entries."""
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(BENCH_DIR, "configs"), bench / "configs")
    shutil.copytree(os.path.join(BENCH_DIR, "traffic"), bench / "traffic")
    (bench / "metrics").mkdir()
    (bench / "limits").mkdir()
    man = json.loads(json.dumps(MAN))
    with open(os.path.join(ROOT_DIR, "benchmark/configs/cornell.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "cornell_copy"
    (bench / "configs" / "cornell_copy.json").write_text(json.dumps(cfg))
    traffic = manifest.traffic("viewer-preview")
    traffic["job_spp"] = 16
    (bench / "traffic" / "viewer-16.json").write_text(json.dumps(traffic))
    (bench / "limits" / "cornell-16.json").write_text(
        json.dumps({"off_px_pct": {"limit": 1.0}}))
    (bench / "metrics" / "passes_seen.py").write_text(
        "def compute(rec):\n    return float(len(rec['passes']))\n")
    man["configs"].append(dict(name="cornell_copy", source="x",
                               file="benchmark/configs/cornell_copy.json",
                               reduced=[], why="x"))
    man["workloads"].append(dict(name="cornell-16", config="cornell_copy",
                                 traffic="viewer-16", chips=1, why="x"))
    man["per_layer"].append(dict(name="passes_seen", unit="passes",
                                 better="higher", source="host_clock",
                                 layer="entry", moves="msamples_per_s",
                                 workloads=["cornell-16"]))
    entry = manifest.cell(man, "cornell-16")
    assert manifest.config(man, entry["config"], root=str(tmp_path))[
        "name"] == "cornell_copy"
    assert manifest.traffic(entry["traffic"], str(bench))["job_spp"] == 16
    assert manifest.limits("cornell-16", str(bench))["off_px_pct"] == \
        {"limit": 1.0}
    found = [m["name"] for m in manifest.metrics_for(man, "cornell-16", True)]
    assert "passes_seen" in found
    reader = manifest.load_metric("passes_seen", str(bench))
    assert reader.compute({"passes": [(0, 1), (1, 2)]}) == 2.0
    assert "passes_seen" not in [
        m["name"] for m in manifest.metrics_for(man, "cornell-640-preview",
                                                 True)]


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        manifest.cell(MAN, "no-such-cell")
    with pytest.raises(KeyError):
        manifest.config(MAN, "no-such-config")
