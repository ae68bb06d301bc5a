"""The port's ``pt::`` spans (``pathtracer_tpu_torch/utils/spans.py``).

Without a profiler no span enters a ``record_function``; under one, a
small render holds every span of the render loop, nested chunk >
band-frame > bounce > leaf, one band-frame a band and sample frame and
``max_depth + 1`` bounces in each, and nearly every top-level torch op
of a band-frame in a layer span below it; the film is the same bits with
and without the profiler. The ``cuda`` tests pair each K1 kernel of a
card render, replayed from CUDA graphs or eager, to its
``pt::k:intersect`` span inside ``pt::intersect`` by its correlation id.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_alpha_scenes
from pathtracer_tpu_torch.core.camera import Camera
from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.scene import MAT_MATTE, SceneBuilder
from pathtracer_tpu_torch.utils import spans

CORNELL = "data/cornell-box.xml"
RES, SPP, CHUNK, DEPTH, BAND_ROWS = (24, 16), 4, 2, 3, 8
LOOP = ("pt::chunk", "pt::chunk_sync", "pt::callback", "pt::band_frame",
        "pt::sampler", "pt::camera", "pt::bounce", "pt::intersect",
        "pt::shade", "pt::nee", "pt::scatter", "pt::film")
# the spans an op of a band-frame may sit in, below the band-frame
LAYERS = ("pt::sampler", "pt::camera", "pt::bounce", "pt::intersect",
          "pt::shade", "pt::nee", "pt::scatter", "pt::film")


def cornell(sampler="sobol"):
    cam, sd, _ = load_mitsuba(CORNELL, resolution=RES, device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=DEPTH, mis_mode="onesample",
                                      sampler=sampler),
                           spp=SPP, band_rows=BAND_ROWS)
    return cam, sd, integ


def render(cam, sd, integ):
    done = []
    film = integ.render_progressive(cam, sd, chunk_spp=CHUNK,
                                    callback=lambda f, d: done.append(d))
    return film, done


def events(prof):
    """(spans [(name, start, end)], top-level torch ops [(name, start,
    end)]) of a stopped profile, each sorted by start."""
    sp, ops = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pt::"):
            sp.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.name().startswith("aten::"):
            ops.append((e.name(), e.start_ns(), e.end_ns()))
    top, end = [], -1
    for op in sorted(ops, key=lambda o: o[1]):
        if op[1] >= end:
            top.append(op)
            end = op[2]
    return sorted(sp, key=lambda s: (s[1], -s[2])), top


def holding(sp, t0, t1=None):
    """Names of the spans holding [t0, t1], outermost first."""
    t1 = t0 if t1 is None else t1
    return [n for n, s, e in sp if s <= t0 and t1 <= e]


@pytest.fixture(scope="module", params=["sobol", "stratified", "random"])
def traced(request):
    """A cornell render of two chunks without and with a CPU profiler:
    (sampler, integrator, bands, films, spans, top-level ops)."""
    cam, sd, integ = cornell(request.param)
    film0, _ = render(cam, sd, integ)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        film1, done = render(cam, sd, integ)
    assert done == [CHUNK, SPP]
    sp, top = events(prof)
    return dict(sampler=request.param, integ=integ,
                bands=integ.band_layout(cam)[1], films=(film0, film1),
                spans=sp, top=top)


def test_no_profiler_enters_no_range(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        entered.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    cam, sd, integ = cornell()
    render(cam, sd, integ)
    assert entered == []
    assert spans.span("pt::chunk") is spans.span("pt::film")
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("pt::band_frame"):
            pass
    assert entered == ["pt::band_frame"]


def test_the_film_is_the_same_under_the_profiler(traced):
    film0, film1 = traced["films"]
    assert torch.equal(film0, film1)


def test_every_span_of_the_loop(traced):
    names = {n for n, _, _ in traced["spans"]}
    assert set(LOOP) <= names, set(LOOP) - names


def test_counts(traced):
    sp = traced["spans"]
    count = {name: sum(n == name for n, _, _ in sp) for name in LOOP}
    frames = traced["bands"] * SPP
    assert count["pt::chunk"] == count["pt::chunk_sync"] == \
        count["pt::callback"] == SPP // CHUNK
    assert count["pt::band_frame"] == count["pt::camera"] == \
        count["pt::film"] == frames
    assert count["pt::bounce"] == frames * (DEPTH + 1)
    # a closest-hit query a bounce, a shadow query a bounce but the last
    assert count["pt::intersect"] == frames * (2 * DEPTH + 1)
    for bf_name, bs, be in sp:
        if bf_name == "pt::band_frame":
            inside = [n for n, s, e in sp if bs <= s and e <= be]
            assert inside.count("pt::bounce") == DEPTH + 1


def test_nesting(traced):
    sp = traced["spans"]
    parent = {"pt::band_frame": "pt::chunk", "pt::chunk_sync": "pt::chunk",
              "pt::callback": "pt::chunk", "pt::camera": "pt::band_frame",
              "pt::film": "pt::band_frame", "pt::bounce": "pt::band_frame",
              "pt::shade": "pt::bounce", "pt::scatter": "pt::bounce",
              "pt::nee": "pt::bounce"}
    hashes = 0
    for name, s, e in sp:
        outer = holding(sp, s, e)[:-1]
        if name == "pt::sampler" and not outer:
            # the hash samplers' pixel hash: once a band of the render,
            # as its band is made, before the chunks
            hashes += 1
            continue
        assert name == "pt::chunk" or outer[0] == "pt::chunk", (name, outer)
        if name in parent:
            assert parent[name] in outer, (name, outer)
        if name == "pt::intersect":
            assert outer[-1] in ("pt::bounce", "pt::nee"), outer
        if name == "pt::sampler":
            assert "pt::band_frame" in outer, outer
    assert hashes == (0 if traced["sampler"] == "sobol" else traced["bands"])


def chains_at(sp, times):
    """The names of the spans holding each of the sorted ``times``,
    outermost first (one sweep; spans nest)."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(sp) and sp[k][1] <= t:
            while stack and stack[-1][2] <= sp[k][1]:
                stack.pop()
            stack.append(sp[k])
            k += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append([n for n, _, _ in stack])
    return out


def test_band_frame_ops_lie_in_layer_spans(traced):
    in_bf = in_layer = 0
    for chain in chains_at(traced["spans"], [s for _, s, _ in traced["top"]]):
        if "pt::band_frame" in chain:
            in_bf += 1
            in_layer += any(n in LAYERS for n in chain)
    assert in_bf > 1000 * traced["bands"]
    assert in_layer >= 0.99 * in_bf, (in_layer, in_bf)


def textured_cutout():
    """A checkered floor under an alpha-masked quad (K1's route with the
    alpha retries): both texture spans."""
    idx, uv = torch_alpha_scenes.IDX, torch_alpha_scenes.UV
    b = SceneBuilder()
    checker = b.add_texture_checker((0.8, 0.8, 0.8), (0.2, 0.2, 0.2),
                                    uv=(4, 4, 0, 0))
    floor = b.add_material(mtype=MAT_MATTE, kd=(0.8, 0.8, 0.8),
                           kd_tx=checker)
    leaf = b.add_material(mtype=MAT_MATTE, kd=(0.2, 0.8, 0.2))
    alpha = np.where(np.indices((8, 8)).sum(0) % 2 == 0, 0.0, 1.0)
    a_txd = b.add_texture_image(np.repeat(alpha[..., None], 3, -1)
                                .astype(np.float32))
    b.add_mesh(np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                        np.float32), idx, None, uv, floor)
    b.add_mesh(np.array([[-2, 1, -2], [2, 1, -2], [2, 1, 2], [-2, 1, 2]],
                        np.float32), idx, None, uv, leaf, alpha_txd=a_txd)
    b.add_point_light((0.0, 3.0, 0.0), (50.0, 50.0, 50.0))
    sd = b.build(device="cpu")
    cam = Camera.look_at([0, 4.0, 4.5], [0, 0, 0], [0, 1, 0], np.pi / 3,
                         (12, 12))
    return cam, sd


def test_texture_and_alpha_spans_sit_in_their_layers():
    cam, sd = textured_cutout()
    integ = PathIntegrator(PathConfig(max_depth=2), spp=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        integ.render(cam, sd)
    sp, _ = events(prof)
    names = [n for n, _, _ in sp]
    assert "pt::texture" in names and "pt::alpha_cut" in names
    for name, s, e in sp:
        outer = holding(sp, s, e)[:-1]
        if name == "pt::texture":
            assert "pt::shade" in outer, outer
        if name == "pt::alpha_cut":
            assert outer[-1] == "pt::intersect", outer


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_k1_kernel_links_to_its_launch_span(card):
    """A short cornell render on the card (its band-frames replayed from
    CUDA graphs cut at every span, ``utils/span_graph.py``): as many
    ``intersect_kernel``s as ``pt::k:intersect`` spans, each span in
    ``pt::intersect``, and each kernel's correlation id naming a runtime
    call inside a span of its own, before the kernel starts."""
    _k1_links(card)


@pytest.mark.cuda
def test_every_k1_kernel_links_to_its_launch_span_eager(card, monkeypatch):
    """As above, the band-frames run eagerly (as an alpha scene's do)."""
    from pathtracer_tpu_torch import integrator

    monkeypatch.setattr(integrator, "_graph_engages", lambda s, c: False)
    _k1_links(card)


def _k1_links(card):
    from torch.autograd import DeviceType

    from pathtracer_tpu_torch.ops.cuda import intersect_cu

    cam, sd, _ = load_mitsuba(CORNELL, resolution=(64, 48), device=card)
    integ = PathIntegrator(PathConfig(max_depth=DEPTH, mis_mode="onesample"),
                           spp=2)
    integ.render(cam, sd)  # builds and loads K1
    torch.cuda.synchronize()
    before = intersect_cu.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        integ.render(cam, sd)
        torch.cuda.synchronize()
    launches = intersect_cu.LAUNCHES - before
    sp, kernels, runtime = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("pt::"):
                sp.append((e.name(), e.start_ns(), e.end_ns()))
            elif e.name().startswith("cuda"):
                runtime[e.correlation_id()] = e.start_ns()
        elif "intersect_kernel<" in e.name() and \
                not e.is_user_annotation():
            kernels.append((e.start_ns(), e.correlation_id()))
    sp.sort(key=lambda s: (s[1], -s[2]))
    k_spans = [(s, e) for n, s, e in sp if n == "pt::k:intersect"]
    assert launches > 0
    assert (len(k_spans), len(kernels)) == (launches, launches)
    for s, e in k_spans:
        assert holding(sp, s, e)[-2:] == ["pt::intersect",
                                          "pt::k:intersect"], \
            holding(sp, s, e)
    owner = []
    for k, corr in kernels:
        t = runtime[corr]
        held = [i for i, (s, e) in enumerate(k_spans) if s <= t <= e]
        assert len(held) == 1 and t < k, (t, k, held)
        owner += held
    assert sorted(owner) == list(range(launches))
