"""The readers' arithmetic on synthetic records."""

import numpy as np
import pytest

from harness import manifest, trace


def metric(name):
    return manifest.load_metric(name).compute


def records(passes, **kw):
    rec = dict(passes=passes, window=(passes[0][0], passes[-1][1]),
               samples_per_pass=1000, setup_s=7.5, peak_mem_bytes=3 << 20,
               jobs_done=1, trace=None)
    rec.update(kw)
    return rec


def test_rate_counts_completed_passes_over_the_window():
    # three passes; the window ends at the end of the last one (t = 4 s)
    rec = records([(0.0, 1.0), (1.0, 2.5), (2.5, 4.0)])
    assert metric("msamples_per_s")(rec) == pytest.approx(3000 / 4.0 / 1e6)
    # a job restart between passes is in the window, not in a pass
    rec = records([(0.0, 1.0), (1.5, 2.5)])
    assert metric("msamples_per_s")(rec) == pytest.approx(2000 / 2.5 / 1e6)


def test_median_over_all_passes():
    spans = np.arange(1, 42) * 1e-3  # 1 .. 41 ms
    t = np.concatenate([[0.0], np.cumsum(spans[::-1])])
    rec = records(list(zip(t[:-1], t[1:])))
    assert metric("pass_ms_p50")(rec) == pytest.approx(21.0)
    # a job restart's gap lies between passes and in none of them
    rec = records([(0.0, 1.0), (5.0, 5.5), (5.5, 6.5)])
    assert metric("pass_ms_p50")(rec) == pytest.approx(1000.0)
    assert metric("setup_s")(rec) == 7.5
    assert metric("peak_mem_mib")(rec) == 3.0
    assert metric("peak_mem_mib")(dict(rec, peak_mem_bytes=0)) is None


def test_union_of_overlapping_intervals():
    merged = trace.union_intervals([(5, 8), (0, 2), (1, 3), (7, 9), (12, 20)],
                                   0, 15)
    assert merged == [[0, 3], [5, 9], [12, 15]]


def test_idle_share_and_gaps():
    device = [("k1", 10, 20), ("k2", 15, 30), ("k1", 60, 70),
              ("k3", 200, 210)]  # the last one outside the span
    host = [("aten::add", 0, 100), ("cudaStreamSynchronize", 35, 55)]
    s = trace.summarise(device, host, (0, 100))
    assert s["busy_s"] == pytest.approx(30e-9)
    assert s["span_s"] == pytest.approx(100e-9)
    assert s["device_ops"] == 3
    assert dict(s["device_ops_top"])["k1"] == pytest.approx(20e-9)
    gaps = dict(s["idle_gaps"])
    # gaps: [0,10] aten::add, [30,60] mid 45 inside the sync, [70,100]
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-9)
    assert gaps["aten::add"] == pytest.approx(40e-9)
    rec = records([(0.0, 1.0)], trace=dict(s, samples=3000, passes=1,
                                           extra={}))
    assert metric("device_idle_pct")(rec) == pytest.approx(70.0)
    assert metric("device_ops_per_ksample")(rec) == pytest.approx(1.0)
    assert metric("device_idle_pct")(records([(0.0, 1.0)])) is None
