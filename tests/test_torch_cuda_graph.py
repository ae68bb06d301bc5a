"""The band-frame's CUDA graph (``integrator._BandGraph``) on the card.

Cornell renders through one ``PathIntegrator`` by graph replay against
the same renders run eagerly: equal bits over two jobs with different
cameras, one capture and the rest replays, K1's launches counted alike,
and the replayed kernels in the profiler's trace in the spans of their
eager launch (``utils/span_graph.py``).
Alpha-masked scenes keep the eager path. These tests need a CUDA card
(marked ``cuda``; without one they skip: a CUDA graph exists only on a
card). The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cuda_graph.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import integrator as pint
from pathtracer_tpu_torch.ops.cuda import bsdf_cu, intersect_cu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")
RES, SPP, CHUNK, DEPTH, BAND_ROWS = (160, 120), 8, 4, 5, 40


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the hand kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _cameras(cam):
    """The scene's camera and one moved off it (eye and aim)."""
    c2w = cam.cam_to_world.copy()
    c2w[:3, 3] += (0.06, -0.03, 0.02)
    c2w[:3, :3] = c2w[:3, :3] @ np.array(
        [[np.cos(0.02), 0, np.sin(0.02)], [0, 1, 0],
         [-np.sin(0.02), 0, np.cos(0.02)]])
    return cam, dataclasses.replace(cam, cam_to_world=c2w)


def _two_jobs(dev):
    """Two cornell jobs through one integrator, in chunks: (films, done
    frames a callback, GRAPH_COUNTS moved, K1 and K5 / K6 launches).
    Between the jobs
    every tensor field of the first job's ``RenderSetup`` and ``Band``
    records is dropped and its block taken by a tensor of garbage, so a
    graph that read an address of the first job's would read garbage."""
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(CORNELL, resolution=RES, device=dev)
    scene = TracedScene.create(sd)
    integ = PathIntegrator(PathConfig(max_depth=DEPTH, mis_mode="onesample"),
                           spp=SPP, band_rows=BAND_ROWS)
    made = []
    setup, band = integ.setup, integ.band

    def spy(make):
        def made_by(*a, **k):
            record = make(*a, **k)
            made.extend(t for t in vars(record).values()
                        if isinstance(t, torch.Tensor))
            return record
        return made_by

    integ.setup, integ.band = spy(setup), spy(band)
    before = dict(pint.GRAPH_COUNTS)
    k1_before = intersect_cu.LAUNCHES
    bsdf_before = dict(bsdf_cu.LAUNCHES)
    films, done = [], []
    for job, camera in enumerate(_cameras(cam)):
        if job:
            shapes = [(t.shape, t.dtype) for t in made]
            made.clear()
            torch.cuda.synchronize()
            junk = [torch.full(s, -7, dtype=d, device=dev) for s, d in shapes]
        film = integ.render_progressive(
            camera, scene, chunk_spp=CHUNK,
            callback=lambda f, d: done.append(d))
        films.append(film.cpu())
    del junk
    moved = {k: v - before[k] for k, v in pint.GRAPH_COUNTS.items()}
    bands = integ.band_layout(cam)[1]
    return dict(films=films, done=done, moved=moved, bands=bands,
                k1=intersect_cu.LAUNCHES - k1_before,
                bsdf={k: v - bsdf_before[k]
                      for k, v in bsdf_cu.LAUNCHES.items()})


@pytest.fixture(scope="module")
def runs(dev):
    """The two jobs by graph replay, then eagerly (the engagement test
    patched to refuse)."""
    out = {"graph": _two_jobs(dev)}
    real = pint._graph_engages
    pint._graph_engages = lambda scene, cfg: False
    try:
        out["eager"] = _two_jobs(dev)
    finally:
        pint._graph_engages = real
    return out


@pytest.mark.cuda
def test_graph_films_equal_the_eager_films_bit_for_bit(runs):
    g, e = runs["graph"], runs["eager"]
    assert g["done"] == e["done"] == [4, 8, 4, 8]
    for got, want in zip(g["films"], e["films"]):
        assert torch.isfinite(got).all() and (got[..., 3] > 0).all()
        assert torch.equal(got, want)
    assert not torch.equal(g["films"][0], g["films"][1])


@pytest.mark.cuda
def test_one_capture_then_replays(runs):
    """One graph serves every band and frame of both jobs: the first
    band-frame captures it, every other replays it; the eager run counts
    every band-frame eager."""
    g, e = runs["graph"], runs["eager"]
    frames = 2 * SPP * g["bands"]
    assert g["bands"] == 4
    assert g["moved"] == dict(captures=1, replays=frames - 1, eager=0)
    assert e["moved"] == dict(captures=0, replays=0, eager=frames)


@pytest.mark.cuda
def test_k1_launches_count_alike_on_both_paths(runs):
    """A replay adds its graph's captured K1 launches; the capture itself
    counts none: a closest-hit and a shadow query a bounce but the last."""
    g, e = runs["graph"], runs["eager"]
    assert g["k1"] == e["k1"] == 2 * SPP * g["bands"] * (2 * DEPTH + 1)


@pytest.mark.cuda
def test_bsdf_launches_count_alike_on_both_paths(runs):
    """K5 and K6 launch once each a shading bounce (NEE's light branch and
    the scatter), on the graph path as eagerly: 10 a band-frame."""
    g, e = runs["graph"], runs["eager"]
    frames = 2 * SPP * g["bands"]
    assert g["bsdf"] == e["bsdf"] == dict(bsdf_eval=frames * DEPTH,
                                          bsdf_sample=frames * DEPTH)


def _profiled(fn):
    """Run ``fn`` under the profiler, synchronised: (the ``pt::`` spans as
    (name, start, end) sorted by start, {correlation id: (runtime call's
    name, start)}, the device ops as (name, correlation id))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, runtime, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("pt::"):
                spans.append((e.name(), e.start_ns(), e.end_ns()))
            elif e.name().startswith("cu"):
                runtime[e.correlation_id()] = (e.name(), e.start_ns())
        elif not e.is_user_annotation():
            ops.append((e.name(), e.correlation_id()))
    spans.sort(key=lambda x: (x[1], -x[2]))
    return spans, runtime, ops


def _held(spans, t):
    """The names of the spans holding time ``t``, outermost first."""
    return [n for n, s, e in spans if s <= t <= e]


@pytest.mark.cuda
def test_replayed_kernels_lie_in_their_band_frame(dev):
    """Under the profiler, a replayed band-frame's device work appears
    kernel by kernel, each linked by correlation id to a graph's launch
    inside ``pt::graph_replay`` inside ``pt::band_frame``: each K1 kernel
    to a launch of its own, in the ``pt::k:intersect`` span inside
    ``pt::intersect`` that the replay opened; K1's kernels as many as the
    replays' counted launches. Each K5 / K6 kernel likewise, in its
    ``pt::k:bsdf_*`` span inside ``pt::nee`` / ``pt::scatter``, in no
    ``pt::bsdf:`` span (cornell holds only MATTE)."""
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(CORNELL, resolution=(64, 48), device=dev)
    scene = TracedScene.create(sd)
    integ = PathIntegrator(PathConfig(max_depth=DEPTH, mis_mode="onesample"),
                           spp=2)
    integ.render(cam, scene)  # captures
    torch.cuda.synchronize()
    before, k1_before = dict(pint.GRAPH_COUNTS), intersect_cu.LAUNCHES
    bsdf_before = dict(bsdf_cu.LAUNCHES)
    spans, runtime, ops = _profiled(lambda: integ.render(cam, scene))
    assert pint.GRAPH_COUNTS["replays"] - before["replays"] == 2
    assert pint.GRAPH_COUNTS["captures"] == before["captures"]
    k1 = [c for n, c in ops if "intersect_kernel<" in n]
    assert len(k1) == intersect_cu.LAUNCHES - k1_before == 2 * (2 * DEPTH + 1)
    assert len(set(k1)) == len(k1)
    for corr in k1:
        name, t = runtime[corr]
        assert name.startswith("cudaGraphLaunch"), name
        held = _held(spans, t)
        assert "pt::band_frame" in held and "pt::graph_replay" in held, held
        assert held[-2:] == ["pt::intersect", "pt::k:intersect"], held
    for kernel, parent in (("bsdf_eval", "pt::nee"),
                           ("bsdf_sample", "pt::scatter")):
        corrs = [c for n, c in ops if kernel + "_kernel" in n]
        assert len(corrs) == bsdf_cu.LAUNCHES[kernel] - bsdf_before[kernel] \
            == 2 * DEPTH
        for corr in corrs:
            name, t = runtime[corr]
            assert name.startswith("cudaGraphLaunch"), name
            held = _held(spans, t)
            assert held[-2:] == [parent, "pt::k:" + kernel], held
            assert not any(n.startswith("pt::bsdf:") for n in held), held


@pytest.mark.cuda
def test_replayed_ops_lie_in_the_spans_of_their_eager_launch(dev):
    """The device ops of a replayed render, counted by the innermost span
    their launch lies in, equal those of the same render run eagerly, for
    every span of the band-frame's body: the layer counts a trace's
    reader takes (sampler, shading, intersect, film) read the same work
    on both paths. The replayed ops all come from graph launches."""
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    body = {"pt::sampler", "pt::camera", "pt::bounce", "pt::shade",
            "pt::nee", "pt::scatter", "pt::intersect", "pt::film",
            "pt::k:intersect"}
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(64, 48), device=dev)
    scene = TracedScene.create(sd)
    cfg = PathConfig(max_depth=DEPTH, mis_mode="onesample")
    counts, launchers = {}, {}
    for mode in ("graph", "eager"):
        real = pint._graph_engages
        if mode == "eager":
            pint._graph_engages = lambda scene, cfg: False
        try:
            integ = PathIntegrator(cfg, spp=2)
            integ.render(cam, scene)  # builds, captures
            torch.cuda.synchronize()
            spans, runtime, ops = _profiled(lambda: integ.render(cam, scene))
        finally:
            pint._graph_engages = real
        got, calls = {}, set()
        for _, corr in ops:
            name, t = runtime.get(corr, (None, None))
            held = _held(spans, t) if t is not None else []
            if held and held[-1] in body:
                got[held[-1]] = got.get(held[-1], 0) + 1
                calls.add(name.split("_v")[0])
        counts[mode], launchers[mode] = got, calls
    assert counts["graph"] == counts["eager"], counts
    assert set(counts["eager"]) >= {"pt::sampler", "pt::shade", "pt::nee",
                                    "pt::k:intersect"}
    assert launchers["graph"] == {"cudaGraphLaunch"}, launchers


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["brute", "dense", "tree", "binary"])
def test_alpha_scenes_stay_eager(dev, route):
    """Each alpha route renders eagerly on the card (no capture, no
    replay) and gives the CPU's film, at RMSE < 1e-3 and alpha rtol 1e-5
    (the Sponza card test's bar)."""
    from pathtracer_tpu_torch.core.camera import Camera
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.scene import SceneBuilder
    from torch_alpha_scenes import ROUTES, build

    fill, use_bvh, _ = ROUTES[route]
    cam = Camera.look_at([0.5, 6.0, 6.5], [0, 0.8, 0], [0, 1, 0], np.pi / 3,
                         (48, 32))
    films = {}
    for where in ("cpu", dev):
        ts = TracedScene.create(build(SceneBuilder, fill, device=where),
                                use_bvh=use_bvh)
        before = dict(pint.GRAPH_COUNTS)
        films[str(where)] = PathIntegrator(
            PathConfig(max_depth=3, mis_mode="onesample"), spp=2).render(
                cam, ts).cpu().numpy()
        moved = {k: v - before[k] for k, v in pint.GRAPH_COUNTS.items()}
        assert moved == dict(captures=0, replays=0, eager=2), moved
    got, want = films[str(dev)], films["cpu"]
    assert np.isfinite(got).all() and (got[..., 3] > 0).all()
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    assert np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2)) < 1e-3


@pytest.mark.cuda
def test_a_capture_under_the_profiler_gives_the_eager_film(dev):
    """A render whose capture happens while a profiler records (the
    CLI's ``--profile``): the eager film's bits, and the trace holds the
    capture's and the replays' spans."""
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(CORNELL, resolution=(64, 48), device=dev)
    scene = TracedScene.create(sd)
    cfg = PathConfig(max_depth=DEPTH, mis_mode="onesample")
    before = dict(pint.GRAPH_COUNTS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        film = PathIntegrator(cfg, spp=4).render(cam, scene)
        torch.cuda.synchronize()
    assert pint.GRAPH_COUNTS["captures"] - before["captures"] == 1
    assert pint.GRAPH_COUNTS["replays"] - before["replays"] == 3
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"pt::graph_capture", "pt::graph_replay"} <= names
    real = pint._graph_engages
    pint._graph_engages = lambda scene, cfg: False
    try:
        want = PathIntegrator(cfg, spp=4).render(cam, scene)
    finally:
        pint._graph_engages = real
    assert torch.equal(film, want)
