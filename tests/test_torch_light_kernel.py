"""Kernel K9 (``light_cu.light_sample`` and ``light_cu.light_pdf``): the
light sample and the area light's density in one launch a call.

On the CPU each wrapper runs its plain twin of ``ops/lights.py``
(``sample_li_plain``, ``pdf_li_plain``: the chain held to the JAX package
in ``test_torch_lights.py`` and ``test_torch_all_lights.py``). These tests
check that, the inputs the kernels refuse, the source's launchers against
the wrapper's signatures, and the kernels' arithmetic: the source compiled
for the host with the host C++ compiler (a shim stands in for the CUDA
runtime; each block's threads run in a loop), held to the plain twins bit
for bit on seeded rows of every light type and every light set: with and
without shading normals, emission facing away, grazing and parallel rays,
degenerate triangles, misses (pdf 0), the environment's lanes beside
the others, and for the density rows whose type the set lacks. The host
model also stands in for the launcher in whole renders on the CPU, each
call's tensors held to the layout the kernel takes: the launches a
band-frame (cornell 5 + 5, the spheres 15 + 15, the flake 15 + 0, the
tank farm 0 + 0) and films equal to those of the plain twins.

The ``cuda``-marked tests hold K9 to the plain twins on the card with
``torch.equal`` on a 640 x 480 band-frame's calls, the inputs it refuses
there, and the films of cornell, the spheres and the flake with K9 and
with the plain twins. They skip here: a CUDA kernel has no CPU or
interpret mode. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_light_kernel.py
"""

import ctypes
import functools
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import integrator as pint
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.ops import lights as lt
from pathtracer_tpu_torch.ops.cuda import _build, light_cu
from pathtracer_tpu_torch.scene import procedural
from pathtracer_tpu_torch.scene.gltf import load_gltf
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.scene import (LA_EMIT, LA_HASN, LA_N0,
                                              LA_N1, LA_N2, LA_P0, LA_P1,
                                              LA_P2, LA_TYPE, LA_VEC,
                                              LA_WIDTH, LIGHT_AREA,
                                              LIGHT_DISTANT, LIGHT_INFINITE,
                                              LIGHT_POINT)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "benchmark", "scenes")
CORNELL = os.path.join(SCENES, "cornell-box.xml")
SPHERES = os.path.join(SCENES, "cornell-spheres.xml")
TANKFARM = os.path.join(SCENES, "tankfarm-spheres.xml")
if SCENES not in sys.path:
    sys.path.insert(0, SCENES)

import make_sphereflake as msf  # noqa: E402

N_HOST = 2053  # ragged: not a multiple of the kernel's block
N_CARD = 130_732  # a 640 x 480 band's lanes
A, P, D, E = LIGHT_AREA, LIGHT_POINT, LIGHT_DISTANT, LIGHT_INFINITE
# the light sets of the sample: each type alone, the three K9 types, all
# four (the environment's lanes from K8), area with the environment, and
# point with distant
SAMPLE_SETS = ((A,), (P,), (D,), (A, P, D), (A, P, D, E), (A, E), (P, D))
# the light sets of the density (with an area light)
PDF_SETS = ((A,), (A, P, D), (A, P, D, E), (A, E), (A, D))
KEYS = ("wi", "pdf", "li", "target_p", "target_err", "target_n", "is_delta",
        "is_env", "is_area")
# the calls a band-frame makes of each kernel: cornell at depth 5 and the
# spheres at 15 under one-sample MIS (a light sample at each shading
# bounce, the area density at each bounce after the first), the flake's
# point lights (samples only) and the tank farm's environment (neither)
BAND_FRAME = dict(cornell=(5, 5), spheres=(15, 15), flake=(15, 0),
                  tankfarm=(0, 0))


@functools.lru_cache(maxsize=None)
def _scene_fields():
    """The tank farm's scene at a small size on the CPU: an environment
    (for the sets that hold one) and a world radius."""
    return load_mitsuba(TANKFARM, resolution=(8, 6), device="cpu")[1]


def _scene(device="cpu"):
    sd = _scene_fields()
    fields = {k: getattr(sd, k) for k in (
        "world_radius", "world_center", "env_map", "env_cond_func",
        "env_cond_cdf", "env_cond_int", "env_marg_func", "env_marg_cdf",
        "env_marg_int", "env_to_world", "world_to_env", "has_env")}
    return types.SimpleNamespace(**{k: v.to(device)
                                    for k, v in fields.items()})


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _cases(n, seed, kinds):
    """Seeded lanes: (rows (n, LA_WIDTH), ref_p, ref_err, ref_n, u,
    wi). Row types drawn from ``kinds``; triangles of any shape and
    orientation, half with shading normals (some flipped against the
    face), a few degenerate (a repeated vertex, three collinear); the
    reference points around them, some in a triangle's own plane (grazing
    directions), some on the triangle itself; u seeded with its edges; wi
    toward a point of the lane's triangle (a hit), random (mostly a miss),
    in the triangle's plane (parallel), or at right angles to the
    reference normal."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, LA_WIDTH), np.float64)
    rows[:, LA_TYPE] = rng.choice(np.asarray(kinds), n)
    rows[:, LA_EMIT] = rng.uniform(0.0, 20.0, (n, 3))
    point = rng.uniform(-3.0, 3.0, (n, 3))
    rows[:, LA_VEC] = np.where(rows[:, LA_TYPE:LA_TYPE + 1] == D,
                               _unit(rng, n), point)
    center = rng.uniform(-2.0, 2.0, (n, 3))
    size = rng.uniform(0.01, 2.0, (n, 1))
    p0 = center + size * rng.normal(size=(n, 3))
    p1 = center + size * rng.normal(size=(n, 3))
    p2 = center + size * rng.normal(size=(n, 3))
    k = n // 16
    p1[:k] = p0[:k]  # a repeated vertex
    p2[k:2 * k] = 0.5 * (p0[k:2 * k] + p1[k:2 * k])  # collinear
    rows[:, LA_P0], rows[:, LA_P1], rows[:, LA_P2] = p0, p1, p2
    face = np.cross(p1 - p0, p2 - p0)
    for sl in (LA_N0, LA_N1, LA_N2):
        flip = rng.choice([-1.0, 1.0], (n, 1))
        rows[:, sl] = flip * (face + 0.3 * rng.normal(size=(n, 3)))
    rows[:, LA_HASN] = rng.integers(0, 2, n)
    ref_p = rng.uniform(-4.0, 4.0, (n, 3))
    # grazing: the reference point in the triangle's own plane
    b = rng.dirichlet(np.ones(3), n)
    inside = b[:, 0:1] * p0 + b[:, 1:2] * p1 + b[:, 2:3] * p2
    graze = slice(2 * k, 3 * k)
    ref_p[graze] = p0[graze] + 2.0 * (p1[graze] - p2[graze])
    ref_err = rng.uniform(0.0, 1e-4, (n, 3))
    ref_err[3 * k:4 * k] = 0.0
    ref_n = _unit(rng, n)
    u = rng.random((n, 2))
    edge = np.float32([0.0, 2.0 ** -24, 0.5, 1.0 - 2.0 ** -24])
    u[4 * k:4 * k + 16] = np.stack(np.meshgrid(edge, edge), -1).reshape(-1, 2)
    wi = inside - ref_p
    wi[5 * k:8 * k] = rng.normal(size=(3 * k, 3))
    # parallel: in the triangle's plane
    par = slice(8 * k, 9 * k)
    wi[par] = p1[par] - p0[par]
    # on the triangle with no error bound: hits at t ~ 0, which the
    # conservative t bound decides
    on = slice(9 * k, 10 * k)
    ref_p[on], ref_err[on] = inside[on], 0.0
    wi[on] = rng.normal(size=(k, 3))
    # level with an axis normal: dot(wi, n) exactly 0 at the offset
    level = slice(10 * k, 11 * k)
    ref_p[level, 2] = inside[level, 2]
    ref_n[level] = 0.0
    ref_n[level, 2] = rng.choice([-1.0, 1.0], k)
    ref_err[level] = 1e-3
    wi[level] = inside[level] - ref_p[level]
    wi = wi / np.maximum(np.linalg.norm(wi, axis=1, keepdims=True), 1e-30)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32))
    return tuple(t(x) for x in (rows, ref_p, ref_err, ref_n, u, wi))


def _same(got: dict, want: dict) -> list:
    """The keys where two sample dicts differ."""
    return [key for key in KEYS if not torch.equal(got[key], want[key])]


# ---------------------------------------------------------------- CPU
@pytest.mark.parametrize("light_set", SAMPLE_SETS, ids=str)
def test_cpu_calls_take_the_plain_twins(light_set):
    """CPU tensors take the plain twins and launch nothing, through the
    wrappers and through ``sample_li`` / ``pdf_li``."""
    sc = _scene()
    rows, ref_p, ref_err, ref_n, u, wi = _cases(300, 1, light_set)
    before = dict(light_cu.LAUNCHES)
    want = lt.sample_li_plain(sc, rows, ref_p, ref_err, ref_n, u,
                              light_set=light_set)
    for fn in (light_cu.light_sample, lt.sample_li):
        assert not _same(fn(sc, rows, ref_p, ref_err, ref_n, u,
                            light_set=light_set), want)
    want = lt.pdf_li_plain(sc, rows, ref_p, ref_err, ref_n, wi,
                           light_set=light_set)
    for fn in (light_cu.light_pdf, lt.pdf_li):
        assert torch.equal(fn(sc, rows, ref_p, ref_err, ref_n, wi,
                              light_set=light_set), want)
    assert light_cu.LAUNCHES == before


def test_inputs_the_kernels_cannot_take_raise():
    """A tensor on a device neither the CPU nor a card, a wrong dtype, or
    inputs on two devices raise before any launch (meta tensors: the
    checks read no data)."""
    sc = _scene()
    rows, ref_p, ref_err, ref_n, u, wi = _cases(64, 2, (A,))
    meta = rows.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        light_cu.light_sample(sc, meta, ref_p, ref_err, ref_n, u)
    with pytest.raises(ValueError, match="cpu or cuda"):
        light_cu.light_pdf(sc, meta, ref_p, ref_err, ref_n, wi)
    with pytest.raises(TypeError, match="float32"):
        light_cu.light_pdf(sc, meta.double(), ref_p, ref_err, ref_n, wi)
    with pytest.raises(ValueError, match="expected cpu"):
        light_cu.light_sample(sc, rows, ref_p, ref_err, ref_n, u.to("meta"))


SAMPLE_WIDTHS = dict(light_rows=LA_WIDTH, ref_p=3, ref_err=3, ref_n=3, u=2,
                     world_radius=())


@pytest.mark.parametrize("change, takes", [
    (lambda t: t, True),
    (lambda t: {**t, "ref_p": t["ref_p"].t().contiguous().t()}, False),
    (lambda t: {**t, "light_rows": t["light_rows"][:, :25].contiguous()},
     False),
    (lambda t: {**t, "u": t["u"].double()}, False),
    (lambda t: {**t, "ref_n": t["ref_n"][1:].contiguous()}, False),
    (lambda t: {**t, "world_radius": t["world_radius"].reshape(1)}, False)],
    ids=["as_called", "strided", "narrow_rows", "float64", "short",
         "radius_not_0d"])
def test_fits_takes_only_the_kernels_layout(change, takes):
    """``_build.fits``, the layout test of K9's launch (and K8's): float32,
    one device, contiguous, (N, width) rows of one N and a 0-d world
    radius; a column view, rows of the wrong width, float64, a short
    input or a world radius of shape (1,) are refused."""
    sc = _scene()
    rows, ref_p, ref_err, ref_n, u, _ = _cases(64, 5, (A,))
    tensors = change(dict(light_rows=rows, ref_p=ref_p, ref_err=ref_err,
                          ref_n=ref_n, u=u, world_radius=sc.world_radius))
    assert _build.fits(tensors, SAMPLE_WIDTHS, light_cu.F32) is takes


def test_source_launchers_match_the_signatures():
    """Each launcher has as many parameters as its signature's letters,
    and the row layout the source reads is scene/scene.py's."""
    with open(os.path.join(_build.CSRC_DIR, light_cu.SOURCE)) as fh:
        src = fh.read()
    for kernel, sig in light_cu.SIGNATURES.items():
        params = re.search(rf"pt_{kernel}_launch\((.*?)\)", src,
                           re.S).group(1)
        assert params.count(",") + 1 == len(sig), kernel
    want = dict(kRow=LA_WIDTH, kType=LA_TYPE, kEmit=LA_EMIT.start,
                kVec=LA_VEC.start, kP0=LA_P0.start, kP1=LA_P1.start,
                kP2=LA_P2.start, kN0=LA_N0.start, kN1=LA_N1.start,
                kN2=LA_N2.start, kHasN=LA_HASN, kArea=A, kPoint=P,
                kDistant=D, kInfinite=E)
    for name, value in want.items():
        assert int(re.search(rf"\b{name} = (\d+)", src).group(1)) == value


# the host model of the kernels: a stand-in for the CUDA runtime, the
# source up to the end of its anonymous namespace, and one C function a
# kernel, of its launcher's parameters, that runs its body for each lane
_SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
struct host_dim3 { unsigned x, y, z; };
static host_dim3 blockIdx, threadIdx;
static inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}
static inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
"""
_LANE_LOOP = r"""
}  // namespace
#define LANES(call)                                            \
  for (int b = 0; b * kThreads < n; ++b)                      \
    for (int t = 0; t < kThreads; ++t) {                       \
      blockIdx.x = b;                                          \
      threadIdx.x = t;                                         \
      call;                                                    \
    }
extern "C" int host_light_sample(
    const float* rows, const float* ref_p, const float* ref_err,
    const float* ref_n, const float* u, const float* world_radius,
    const float* env_wi, const float* env_pdf, const float* env_li, int n,
    float g2, float g3, float g5, float g6, float* out, uint8_t* flags) {
  LANES(light_sample_kernel(rows, ref_p, ref_err, ref_n, u, world_radius,
                            env_wi, env_pdf, env_li, n, g2, g3, g5, g6, out,
                            flags));
  return 0;
}
extern "C" int host_light_pdf(const float* rows, const float* ref_p,
                              const float* ref_err, const float* ref_n,
                              const float* wi, const float* env_pdf, int n,
                              int every, float g2, float g3, float g5,
                              float* out) {
  LANES(light_pdf_kernel(rows, ref_p, ref_err, ref_n, wi, env_pdf, n, every,
                         g2, g3, g5, out));
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_model(tmp_path_factory):
    """csrc/light.cu compiled for the host with ``c++`` (its launchers
    left out: the rest is plain C++ under the shim)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("light_host")
    (tmp / "cuda_runtime.h").write_text(_SHIM)
    with open(os.path.join(_build.CSRC_DIR, light_cu.SOURCE)) as fh:
        src = fh.read()
    (tmp / "model.cpp").write_text(src[:src.index("}  // namespace")] +
                                   _LANE_LOOP)
    lib = tmp / "liblight_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", f"-I{tmp}", "-w",
                    "-o", str(lib), str(tmp / "model.cpp")], check=True,
                   capture_output=True)
    model = ctypes.CDLL(str(lib))
    arg = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    for kernel, sig in light_cu.SIGNATURES.items():
        fn = getattr(model, f"host_{kernel}")
        fn.argtypes = [arg[c] for c in sig[:-1]]
        fn.restype = ctypes.c_int
    return model


@pytest.fixture
def on_host(host_model, monkeypatch):
    """The wrappers' launch path with the host model as the launcher: CPU
    tensors take it as the card's take the kernel, held to the layout the
    kernel takes (``_build.fits``: dtypes, contiguity, shapes), so a call
    site that hands K9 a view it cannot take fails here, and
    ``_build.launch`` calls the model's lane loop and counts each call in
    ``light_cu.LAUNCHES``, as on the card."""
    def trampoline(kernel):
        fn = getattr(host_model, f"host_{kernel}")
        return lambda address, *args: fn(*args[:-1])

    real = _build.device

    def device(what, tensors, widths, *args):
        if what not in light_cu.SIGNATURES:
            return real(what, tensors, widths, *args)
        assert _build.fits(tensors, widths, light_cu.F32), (
            f"{what}: a layout the kernel cannot take: " + ", ".join(
                f"{k} {tuple(t.shape)} {t.stride()}"
                for k, t in tensors.items()))
        return 0

    monkeypatch.setattr(light_cu, "_fns", {
        k: (trampoline(k), 0) for k in light_cu.SIGNATURES})
    monkeypatch.setattr(_build, "device", device)
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 0)
    return host_model


@pytest.mark.parametrize("light_set", SAMPLE_SETS, ids=str)
@pytest.mark.parametrize("kinds", ["mixed", "first"])
def test_sample_source_on_the_host_matches_plain(on_host, light_set, kinds):
    """``light_sample``, run on the host a lane at a time through the
    wrapper's launch path, gives the plain twin's bits on every lane and
    every output: rows of each of the set's types mixed lane by lane, and
    rows all of the set's first type (every warp on one branch)."""
    sc = _scene()
    rows, ref_p, ref_err, ref_n, u, _ = _cases(
        N_HOST, 11, light_set) if kinds == "mixed" else _cases(
        N_HOST, 13, light_set[:1])
    before = light_cu.LAUNCHES["light_sample"]
    got = light_cu.light_sample(sc, rows, ref_p, ref_err, ref_n, u,
                                light_set=light_set)
    assert light_cu.LAUNCHES["light_sample"] == before + 1
    want = lt.sample_li_plain(sc, rows, ref_p, ref_err, ref_n, u,
                              light_set=light_set)
    assert not _same(got, want)
    if A in light_set:
        area = rows[:, LA_TYPE] == A
        # hits and misses, emission toward and away from the receiver
        assert (got["pdf"][area] > 0).any() and (got["pdf"][area] == 0).any()
        lit = (got["li"] != 0).any(-1)
        assert lit[area].any() and (~lit[area]).any()


@pytest.mark.parametrize("light_set", PDF_SETS, ids=str)
@pytest.mark.parametrize("kinds", ["own", "all"])
def test_pdf_source_on_the_host_matches_plain(on_host, light_set, kinds):
    """``light_pdf``, run on the host a lane at a time, gives the plain
    twin's bits on every lane: hits, misses (pdf 0), parallel and grazing
    directions, degenerate triangles, the environment's density on its
    lanes, 0 on the delta lights'."""
    sc = _scene()
    rows, ref_p, ref_err, ref_n, _, wi = _cases(
        N_HOST, 12, light_set if kinds == "own" else (A, P, D, E))
    before = light_cu.LAUNCHES["light_pdf"]
    got = light_cu.light_pdf(sc, rows, ref_p, ref_err, ref_n, wi,
                             light_set=light_set)
    assert light_cu.LAUNCHES["light_pdf"] == before + 1
    want = lt.pdf_li_plain(sc, rows, ref_p, ref_err, ref_n, wi,
                           light_set=light_set)
    assert torch.equal(got, want)
    assert (got > 0).any() and (got == 0).any()


def test_kernel_only_sets_are_refused(on_host):
    """The wrappers refuse a set K9 does not evaluate (the environment
    alone, a density without an area light): ``sample_li`` / ``pdf_li``
    take the plain chain there, launching nothing."""
    sc = _scene()
    rows, ref_p, ref_err, ref_n, u, wi = _cases(64, 3, (E,))
    with pytest.raises(ValueError, match="no area, point or distant"):
        light_cu.light_sample(sc, rows, ref_p, ref_err, ref_n, u,
                              light_set=(E,))
    with pytest.raises(ValueError, match="no area light"):
        light_cu.light_pdf(sc, rows, ref_p, ref_err, ref_n, wi,
                           light_set=(P, E))
    before = dict(light_cu.LAUNCHES)
    assert not _same(lt.sample_li(sc, rows, ref_p, ref_err, ref_n, u,
                                  light_set=(E,)),
                     lt.sample_li_plain(sc, rows, ref_p, ref_err, ref_n, u,
                                        light_set=(E,)))
    assert torch.equal(lt.pdf_li(sc, rows, ref_p, ref_err, ref_n, wi,
                                 light_set=(P, E)),
                       lt.pdf_li_plain(sc, rows, ref_p, ref_err, ref_n, wi,
                                       light_set=(P, E)))
    assert light_cu.LAUNCHES == before


# ------------------------------------------------------- calls a render
@pytest.fixture(scope="module")
def flake(tmp_path_factory):
    """The generator's sphereflake at size factor 1 (91 spheres, three
    point lights)."""
    return msf.write(str(tmp_path_factory.mktemp("flake") / "sf1.gltf"), 1)


def _load(name, flake_path, device="cpu", resolution=(12, 8)):
    if name == "flake":
        cam, sd, _ = load_gltf(flake_path, resolution=resolution,
                               device=device)
    else:
        path = dict(cornell=CORNELL, spheres=SPHERES, tankfarm=TANKFARM)[name]
        cam, sd, _ = load_mitsuba(path, resolution=resolution, device=device)
    return cam, sd


def _depth(name):
    return 5 if name == "cornell" else 15


@pytest.mark.parametrize("name", list(BAND_FRAME))
def test_band_frame_launches_and_films_through_the_host_model(
        on_host, monkeypatch, flake, name):
    """Each cell's band-frames, with the host model as K9's launcher: the
    launches a band-frame (cornell 5 + 5, the spheres 15 + 15, the flake
    15 + 0, the tank farm 0 + 0), and a film equal to the plain twins'."""
    cam, sd = _load(name, flake)
    cfg = PathConfig(max_depth=_depth(name), mis_mode="onesample")
    before = dict(light_cu.LAUNCHES)
    frames = pint.GRAPH_COUNTS["eager"]
    film = PathIntegrator(cfg, spp=2).render(cam, TracedScene.create(sd))
    frames = pint.GRAPH_COUNTS["eager"] - frames
    got = tuple(light_cu.LAUNCHES[k] - before[k]
                for k in ("light_sample", "light_pdf"))
    assert frames == 2
    assert got == tuple(frames * k for k in BAND_FRAME[name])
    monkeypatch.undo()
    want = PathIntegrator(cfg, spp=2).render(cam, TracedScene.create(sd))
    assert light_cu.LAUNCHES == {k: v + g for (k, v), g in
                                 zip(before.items(), got)}
    assert torch.equal(film, want)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("case", [
    dict(), dict(mis_mode="ref"), dict(light_strategy="all"),
    dict(max_depth=2), dict(scene="spheres"), dict(scene="tankfarm"),
    dict(scene="flake"), dict(scene="config_d"),
    dict(scene="config_d", mis_mode="ref"),
    dict(scene="config_d", light_strategy="all")],
    ids=["onesample", "ref", "all_lights", "depth2", "spheres", "tankfarm",
         "flake", "config_d", "config_d_ref", "config_d_all"])
def test_chip_smoke_counts_a_renders_light_calls(on_host, flake, case):
    """``chip_smoke.light_launches``, which every main path's timed
    renders on the card hold K9's launches to, gives the launches a
    render makes: MIS modes, light strategies, depths, each cell's scene,
    config D (a point light and the environment)."""
    smoke = _smoke()
    case = dict(case)
    name = case.pop("scene", "cornell")
    if name == "config_d":
        cam, sd = procedural.envmap_disney_scene((12, 8), device="cpu")
    else:
        cam, sd = _load(name, flake)
    integ = PathIntegrator(PathConfig(**{**dict(max_depth=5,
                                                mis_mode="onesample"),
                                         **case}), spp=2)
    scene = TracedScene.create(sd)
    before = dict(light_cu.LAUNCHES)
    integ.render(cam, scene)
    got = {k: v - before[k] for k, v in light_cu.LAUNCHES.items()}
    assert got == smoke.light_launches(integ, cam, scene)


# ---------------------------------------------------------------- card
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with "
                    "no CPU or interpret mode")
    return torch.device("cuda")


def _card_calls(dev, name, flake_path):
    """The arguments of every ``sample_li`` / ``pdf_li`` call of a
    640 x 480 render's band 0 frame 0 on the card (the eager path, taken
    by a spy): [(kind, args, light_set)]."""
    smoke = _smoke()
    cam, sd = _load(name, flake_path, device=dev, resolution=(640, 480))
    return smoke.capture_light_inputs(cam, TracedScene.create(sd),
                                      _depth(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "spheres", "flake"])
def test_kernels_match_plain_on_a_band_frame(dev, flake, name):
    """K9 ``torch.equal`` to the plain twins on the card on every call of
    a 640 x 480 band-frame (130,732 lanes), one launch a call."""
    calls = _card_calls(dev, name, flake)
    assert calls and calls[0][1][1].shape[0] == N_CARD
    for kind, args, light_set in calls:
        key = "light_sample" if kind == "sample" else "light_pdf"
        before = light_cu.LAUNCHES[key]
        if kind == "sample":
            got = light_cu.light_sample(*args, light_set=light_set)
            want = lt.sample_li_plain(*args, light_set=light_set)
            assert not _same(got, want)
        else:
            got = light_cu.light_pdf(*args, light_set=light_set)
            want = lt.pdf_li_plain(*args, light_set=light_set)
            assert torch.equal(got, want)
        assert light_cu.LAUNCHES[key] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("light_set", SAMPLE_SETS, ids=str)
def test_kernels_match_plain_on_seeded_rows(dev, light_set):
    """K9 ``torch.equal`` to the plain twins on the card on the host
    tests' seeded rows at 130,732 lanes, every set: the sample on rows of
    the set's types, the density on rows of every type."""
    sc = _scene(dev)
    rows, ref_p, ref_err, ref_n, u, _ = (
        t.to(dev) for t in _cases(N_CARD, 31, light_set))
    got = light_cu.light_sample(sc, rows, ref_p, ref_err, ref_n, u,
                                light_set=light_set)
    assert not _same(got, lt.sample_li_plain(sc, rows, ref_p, ref_err, ref_n,
                                             u, light_set=light_set))
    rows, ref_p, ref_err, ref_n, _, wi = (
        t.to(dev) for t in _cases(N_CARD, 32, (A, P, D, E)))
    if A in light_set:
        assert torch.equal(
            light_cu.light_pdf(sc, rows, ref_p, ref_err, ref_n, wi,
                               light_set=light_set),
            lt.pdf_li_plain(sc, rows, ref_p, ref_err, ref_n, wi,
                            light_set=light_set))


@pytest.mark.cuda
def test_card_inputs_the_kernels_cannot_take_raise(dev):
    """On the card: rows of the wrong width, a point not contiguous,
    float64 u, inputs on two devices, or a world radius that is not 0-d
    raise before any launch."""
    sc = _scene(dev)
    rows, ref_p, ref_err, ref_n, u, wi = (t.to(dev)
                                          for t in _cases(64, 4, (A,)))
    before = dict(light_cu.LAUNCHES)
    with pytest.raises(ValueError, match="shapes"):
        light_cu.light_sample(sc, rows[:, :25].contiguous(), ref_p, ref_err,
                              ref_n, u)
    with pytest.raises(ValueError, match="contiguous"):
        light_cu.light_pdf(sc, rows, ref_p.t().contiguous().t(), ref_err,
                           ref_n, wi)
    with pytest.raises(TypeError, match="float32"):
        light_cu.light_sample(sc, rows, ref_p, ref_err, ref_n, u.double())
    with pytest.raises(ValueError, match="expected"):
        light_cu.light_pdf(sc, rows, ref_p, ref_err, ref_n, wi.cpu())
    radius = types.SimpleNamespace(**{**vars(sc), "world_radius":
                                      sc.world_radius.reshape(1)})
    with pytest.raises(ValueError, match="shapes"):
        light_cu.light_sample(radius, rows, ref_p, ref_err, ref_n, u)
    assert light_cu.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "spheres", "flake"])
def test_films_equal_with_k9_and_the_plain_twins(dev, monkeypatch, flake,
                                                 name):
    """Films of two 96 x 72 8-spp renders, graph replay with K9 and the
    eager loop with the plain twins, are ``torch.equal``; K9 launches its
    band-frame counts on the first and none on the second."""
    cam, sd = _load(name, flake, device=dev, resolution=(96, 72))
    cfg = PathConfig(max_depth=_depth(name), mis_mode="onesample")
    before = dict(light_cu.LAUNCHES)
    frames = sum(pint.GRAPH_COUNTS.values())
    film = PathIntegrator(cfg, spp=8, band_rows=24).render(
        cam, TracedScene.create(sd)).cpu()
    frames = sum(pint.GRAPH_COUNTS.values()) - frames
    got = tuple(light_cu.LAUNCHES[k] - before[k]
                for k in ("light_sample", "light_pdf"))
    assert got == tuple(frames * k for k in BAND_FRAME[name])
    monkeypatch.setattr(pint, "_graph_engages", lambda scene, cfg: False)
    monkeypatch.setattr(light_cu, "light_sample", lt.sample_li_plain)
    monkeypatch.setattr(light_cu, "light_pdf", lt.pdf_li_plain)
    before = dict(light_cu.LAUNCHES)
    want = PathIntegrator(cfg, spp=8, band_rows=24).render(
        cam, TracedScene.create(sd)).cpu()
    assert light_cu.LAUNCHES == before
    assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
    assert torch.equal(film, want)
