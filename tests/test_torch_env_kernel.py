"""Kernel K8 (``env_cu.env_eval`` and ``env_cu.env_sample``): the
environment light evaluated and sampled in one launch a call.

On the CPU each wrapper runs its plain twin of ``ops/lights.py``
(``env_eval_plain``, ``env_sample_plain``: the chain held to the JAX
package in ``test_torch_lights.py`` and to the benchmark's reference in
``test_torch_tankfarm.py``). These tests check that, the inputs the
kernels refuse, ``env_le_pdf`` against ``env_le`` and ``env_pdf_li``, the
source's launchers against the wrapper's signatures, the calls a
band-frame makes and ``chip_smoke.env_launches``, and the kernels'
arithmetic: the source compiled for the host with the host C++ compiler
(a shim stands in for the CUDA runtime; each block's threads run in a
loop, twice, so that the first round stages the block's marginal cdf as
``__syncthreads`` would have it staged), held to the plain twins bit for
bit. The host's libm is not CUDA's, so ``acosf``, ``atan2f``, ``sinf``
and ``cosf`` are taken as the double-precision function rounded once, on
both sides (the plain twins' torch.arccos, atan2, sin and cos likewise):
then every search offset, tap, select and float agrees exactly, with no
tolerance. The cases: seeded directions of any length and seeded u, the
map's poles, the u seam (phi at 0, 2 pi and atan2's signed zeros), the
zero direction, u at 0, 2^-24, 1 - 2^-24 and 1, u on the tables' own cdf
entries, tables with zero-integral rows, a marginal too long to stage
(read in place), an odd-sized map, and the no-environment scene's 1x1
zero tables. Tables whose width or height is not a power of two are held
on the card alone: PyTorch's CPU op divides by a Python scalar, where its
CUDA op and the kernels multiply by the reciprocal.

The ``cuda``-marked tests hold K8 to the plain twins on the card with
``torch.equal`` on the same cases at 130,732 lanes, the tank farm's films
graph = eager = plain twins, and the launches a band-frame (16
``env_eval`` + 15 ``env_sample`` on the tank farm, none on cornell). They
skip here: a CUDA kernel has no CPU or interpret mode. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_env_kernel.py
"""

import collections
import ctypes
import dataclasses
import functools
import importlib.util
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import integrator as pint
from pathtracer_tpu_torch.core.sampling import Distribution2D
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.ops import lights as lt
from pathtracer_tpu_torch.ops.cuda import _build, env_cu
from pathtracer_tpu_torch.scene import procedural
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.scene import _env_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TANKFARM = os.path.join(ROOT, "benchmark", "scenes", "tankfarm-spheres.xml")
CORNELL = os.path.join(ROOT, "benchmark", "scenes", "cornell-box.xml")

N_HOST = 2053  # ragged: not a multiple of the kernel's block
N_CARD = 130_732  # a 640 x 480 band's lanes
ENV_FIELDS = ("env_map", "env_cond_func", "env_cond_cdf", "env_cond_int",
              "env_marg_func", "env_marg_cdf", "env_marg_int",
              "env_to_world", "world_to_env", "has_env")
SCENES = ("tankfarm", "cornell", "odd", "pow2", "tall")
# PyTorch's CPU op divides by a Python scalar where its CUDA op multiplies
# by the reciprocal, as the kernels do: the two agree where the count
# divided by, a table's width or height, is a power of two, and there the
# host model is held to the CPU's plain twins (the card holds the kernels
# to the plain twins on every scene)
HOST_SCENES = ("tankfarm", "cornell", "pow2", "tall")
# a band-frame's K8 calls at depth 15 under one-sample MIS with the
# environment the one light: the escaped rays at each of 16 bounces, the
# light sample at each of 15 shading bounces
BAND_FRAME = dict(env_eval=16, env_sample=15)


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def _holder(fields, has_env=True, device="cpu"):
    """The environment fields as a scene's (a namespace of tensors)."""
    out = {k: torch.as_tensor(np.asarray(v), device=device)
           for k, v in fields.items()}
    out["has_env"] = torch.tensor(has_env, device=device)
    return types.SimpleNamespace(**out)


@functools.lru_cache(maxsize=None)
def _scene_fields(name):
    """{field: numpy array} of a scene's environment: the tank farm's 1k
    map, cornell's 1x1 zero placeholders, an odd-sized map (7 x 13, its
    tables 14 x 26) whose first and last rows are black (zero-integral
    table rows), the same map with tables of 16 x 32 cells and zero rows,
    and tables of 8,192 rows (a marginal longer than the kernel stages)
    with zero rows inside."""
    if name in ("tankfarm", "cornell"):
        path = TANKFARM if name == "tankfarm" else CORNELL
        sd = load_mitsuba(path, resolution=(8, 6), device="cpu")[1]
        return {k: getattr(sd, k).numpy() for k in ENV_FIELDS}
    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 4.0, (7, 13, 3)).astype(np.float32)
    img[0] = img[-1] = 0.0
    img[3, 4:9] = 0.0
    if name == "odd":
        fields = _env_tables(img, _rotation(3))
    else:
        rows, cols = (16, 32) if name == "pow2" else (8192, 4)
        func = rng.uniform(0.0, 2.0, (rows, cols)).astype(np.float32)
        func[rows // 2:rows // 2 + rows // 8] = 0.0
        func[-3:] = 0.0
        func[:2] = 0.0
        func[5, :cols // 2] = 0.0
        l2w = _rotation(4)
        fields = {"env_" + k: v
                  for k, v in Distribution2D.build_host(func).items()}
        fields.update(env_map=img, env_to_world=l2w,
                      world_to_env=np.linalg.inv(l2w).astype(np.float32))
    fields["has_env"] = np.asarray(True)
    return fields


def _scene(name, device="cpu"):
    fields = dict(_scene_fields(name))
    has_env = bool(fields.pop("has_env"))
    return _holder(fields, has_env, device)


def _directions(sc, n, seed):
    """(n, 3) world directions: seeded ones of random length, then the
    edges: the map's poles, the u seam (in the map's frame phi at 0, just
    below 2 pi, and atan2 of signed zeros), level and near-pole ones, and
    the zero direction."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)) * rng.uniform(0.05, 20.0, (n, 1))
    l2w = sc.env_to_world.double().cpu().numpy()
    edges = [(0, 0, 1), (0, 0, -1), (1, 0, 0), (1, -1e-9, 0), (1, 1e-9, 0),
             (-1, 0.0, 0), (-1, -0.0, 0), (0.6, -0.0, 0.8), (0, 1, 0),
             (1e-8, 0, 1), (-1e-8, 1e-8, -1), (0.3, -1e-7, -0.95)]
    world = [l2w @ np.asarray(e, np.float64) for e in edges]
    world += [np.asarray(e, np.float64) for e in edges]  # unrotated too
    d[:len(world)] = world
    d[len(world)] = 0.0
    return torch.as_tensor(d.astype(np.float32), device=sc.env_map.device)


def _us(sc, n, seed):
    """(n, 2) u: seeded ones in [0, 1), then the edges: 0, 2^-24,
    1 - 2^-24 and 1 in each coordinate, and u on the tables' own cdf
    entries (the marginal's in u[1], row entries in u[0])."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, 2), dtype=np.float32)
    edge = np.float32([0.0, 2.0 ** -24, 0.5, 1.0 - 2.0 ** -24, 1.0])
    grid = np.stack(np.meshgrid(edge, edge), -1).reshape(-1, 2)
    marg = sc.env_marg_cdf.cpu().numpy()
    cond = sc.env_cond_cdf.cpu().numpy()
    k = min(64, marg.shape[0])
    on_cdf = np.stack([cond[rng.integers(0, cond.shape[0], k),
                            rng.integers(0, cond.shape[1], k)],
                       marg[rng.integers(0, marg.shape[0], k)]], -1)
    edges = np.concatenate([grid, on_cdf])
    u[:len(edges)] = edges
    return torch.as_tensor(u, device=sc.env_map.device)


# ---------------------------------------------------------------- CPU
@pytest.mark.parametrize("name", SCENES)
def test_cpu_calls_take_the_plain_twins(name):
    """CPU tensors take the plain twins and launch nothing: each output
    the twin's, and ``env_le`` / ``env_pdf_li`` / ``_env_sample_li`` the
    wrappers' (their ``pt::env`` bodies)."""
    sc = _scene(name)
    d, u = _directions(sc, 300, 1), _us(sc, 300, 2)
    before = dict(env_cu.LAUNCHES)
    for le, pdf in ((True, False), (False, True), (True, True)):
        got = env_cu.env_eval(sc, d, le=le, pdf=pdf)
        want = lt.env_eval_plain(sc, d, le=le, pdf=pdf)
        for g, w, asked in zip(got, want, (le, pdf)):
            assert (g is None) == (not asked)
            assert g is None or torch.equal(g, w)
    assert torch.equal(lt.env_le(sc, d), lt.env_eval_plain(sc, d)[0])
    assert torch.equal(lt.env_pdf_li(sc, d),
                       lt.env_eval_plain(sc, d, le=False, pdf=True)[1])
    for g, w in zip(lt._env_sample_li(sc, u), lt.env_sample_plain(sc, u)):
        assert torch.equal(g, w)
    assert env_cu.LAUNCHES == before


@pytest.mark.parametrize("name", SCENES)
def test_env_le_pdf_equals_env_le_and_env_pdf_li(name):
    """The escape leg's one call gives the bits of the two it replaces,
    and the no-environment scene zero in both."""
    sc = _scene(name)
    d = _directions(sc, 500, 3)
    le, pdf = lt.env_le_pdf(sc, d)
    assert torch.equal(le, lt.env_le(sc, d))
    assert torch.equal(pdf, lt.env_pdf_li(sc, d))
    if name == "cornell":
        assert not le.any() and not pdf.any()
    else:
        assert (pdf > 0).any() and (le > 0).any()


def test_inputs_the_kernels_cannot_take_raise():
    """A tensor on a device neither the CPU nor a card, a wrong dtype, or
    inputs on two devices raise before any launch (meta tensors: the
    checks read no data); the shape test refuses tables that do not fit
    each other or the map, and a has_env that is not 0-d."""
    sc = _scene("odd")
    meta = torch.empty((16, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        env_cu.env_eval(sc, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        env_cu.env_sample(sc, torch.empty((16, 2), device="meta"))
    with pytest.raises(TypeError, match="float32"):
        env_cu.env_eval(sc, meta.double())
    on_meta = types.SimpleNamespace(**{k: getattr(sc, k).to("meta")
                                       for k in ENV_FIELDS})
    with pytest.raises(ValueError, match="expected cpu"):
        env_cu.env_eval(on_meta, torch.zeros((4, 3)))
    for fields in (env_cu.EVAL_FIELDS, env_cu.SAMPLE_FIELDS):
        for name in SCENES:
            assert env_cu._shapes_ok(_scene(name), fields)
    bad = [dict(env_cond_cdf=sc.env_cond_cdf[:, :-1]),
           dict(env_marg_cdf=sc.env_marg_cdf[:-1]),
           dict(env_cond_int=sc.env_cond_int[:-1]),
           dict(env_marg_func=sc.env_marg_func[1:]),
           dict(env_to_world=sc.env_to_world[:2]),
           dict(env_map=sc.env_map[..., :2]),
           dict(env_map=sc.env_map[:0])]
    for change in bad:
        broken = types.SimpleNamespace(**{**vars(sc), **change})
        assert not env_cu._shapes_ok(broken, env_cu.SAMPLE_FIELDS), change
    broken = types.SimpleNamespace(**{**vars(sc),
                                      "has_env": torch.tensor([True])})
    assert not env_cu._shapes_ok(broken, env_cu.EVAL_FIELDS)


def test_source_constants_match_the_wrapper():
    """Each launcher has as many parameters as its signature's letters;
    the marginal of a 4k map's tables (4,097 entries) is staged, the tank
    farm's too."""
    with open(os.path.join(_build.CSRC_DIR, env_cu.SOURCE)) as fh:
        src = fh.read()
    for kernel, sig in env_cu.SIGNATURES.items():
        params = re.search(rf"pt_{kernel}_launch\((.*?)\)", src,
                           re.S).group(1)
        assert params.count(",") + 1 == len(sig), kernel
    stage = int(re.search(r"#define MARG_STAGE (\d+)", src).group(1))
    assert stage == 2 * 2048 + 1
    assert _scene("tankfarm").env_marg_cdf.shape[0] <= stage
    assert _scene("tall").env_marg_cdf.shape[0] > stage


# the host model of the kernels: a stand-in for the CUDA runtime, the
# source up to the end of its anonymous namespace, and one C function a
# kernel that runs its body for each lane
_SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct host_dim3 { unsigned x, y, z; };
static host_dim3 blockIdx, threadIdx;
static inline void __syncthreads() {}
static inline float host_acosf(float x) { return (float)acos((double)x); }
static inline float host_atan2f(float y, float x) {
  return (float)atan2((double)y, (double)x);
}
static inline float host_sinf(float x) { return (float)sin((double)x); }
static inline float host_cosf(float x) { return (float)cos((double)x); }
#define acosf host_acosf
#define atan2f host_atan2f
#define sinf host_sinf
#define cosf host_cosf
"""
_LANE_LOOP = r"""
}  // namespace
// each block's threads twice: the first round stages its marginal cdf
#define LANES(call)                                            \
  for (int b = 0; b * kThreads < n; ++b)                      \
    for (int round = 0; round < 2; ++round)                   \
      for (int t = 0; t < kThreads; ++t) {                     \
        blockIdx.x = b;                                        \
        threadIdx.x = t;                                       \
        call;                                                  \
      }
extern "C" void host_env_eval(const float* d, const float* w2e,
                              const float* img, const float* cond_func,
                              const float* marg_int, const uint8_t* has_env,
                              int n, int h, int w, int nv, int nu, float* le,
                              float* pdf) {
  LANES(env_eval_kernel(d, w2e, img, cond_func, marg_int, has_env, n, h, w,
                        nv, nu, le, pdf));
}
extern "C" void host_env_sample(const float* u, const float* e2w,
                                const float* img, const float* cond_func,
                                const float* cond_cdf, const float* cond_int,
                                const float* marg_func,
                                const float* marg_cdf, const float* marg_int,
                                int n, int h, int w, int nv, int nu,
                                float* wi, float* pdf, float* le) {
  const int steps = search_steps((int64_t)nu + 1);
  LANES(env_sample_kernel(u, e2w, img, cond_func, cond_cdf, cond_int,
                          marg_func, marg_cdf, marg_int, n, h, w, nv, nu,
                          steps, wi, pdf, le));
}
"""


@pytest.fixture(scope="module")
def host_model(tmp_path_factory):
    """csrc/env.cu compiled for the host with ``c++`` (its launchers left
    out: the rest is plain C++ under the shim)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("env_host")
    (tmp / "cuda_runtime.h").write_text(_SHIM)
    with open(os.path.join(_build.CSRC_DIR, env_cu.SOURCE)) as fh:
        src = fh.read()
    (tmp / "model.cpp").write_text(src[:src.index("}  // namespace")] +
                                   _LANE_LOOP)
    lib = tmp / "libenv_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", f"-I{tmp}", "-w",
                    "-o", str(lib), str(tmp / "model.cpp")], check=True,
                   capture_output=True)
    model = ctypes.CDLL(str(lib))
    arg = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for kernel, sig in env_cu.SIGNATURES.items():
        getattr(model, f"host_{kernel}").argtypes = [arg[c]
                                                     for c in sig[:-1]]
    return model


@pytest.fixture
def double_trig(monkeypatch):
    """torch.arccos / atan2 / sin / cos in float64 rounded once, as the
    host model takes acosf / atan2f / sinf / cosf."""
    acos, atan2 = torch.arccos, torch.atan2
    cos, sin = torch.cos, torch.sin
    monkeypatch.setattr(torch, "arccos", lambda x: acos(x.double()).float())
    monkeypatch.setattr(torch, "atan2",
                        lambda y, x: atan2(y.double(), x.double()).float())
    monkeypatch.setattr(torch, "cos", lambda x: cos(x.double()).float())
    monkeypatch.setattr(torch, "sin", lambda x: sin(x.double()).float())


def _sizes(sc):
    h, w = sc.env_map.shape[:2]
    nv, nu = sc.env_cond_func.shape
    return [h, w, nv, nu]


def _ptrs(sc, fields):
    return [getattr(sc, f).data_ptr() for f in fields]


@pytest.mark.parametrize("name", HOST_SCENES)
def test_eval_source_on_the_host_matches_plain(host_model, double_trig,
                                               name):
    """``env_eval``, run on the host a lane at a time, gives the plain
    twin's bits on every lane: radiance alone, the pdf alone, both."""
    sc = _scene(name)
    d = _directions(sc, N_HOST, 11)
    for le, pdf in ((True, False), (False, True), (True, True)):
        got = [torch.full((N_HOST, 3), -7.0) if le else None,
               torch.full((N_HOST,), -7.0) if pdf else None]
        host_model.host_env_eval(
            d.data_ptr(), *_ptrs(sc, env_cu.EVAL_FIELDS), N_HOST,
            *_sizes(sc), *(0 if g is None else g.data_ptr() for g in got))
        want = lt.env_eval_plain(sc, d, le=le, pdf=pdf)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or torch.equal(g, w), (le, pdf)


@pytest.mark.parametrize("name", HOST_SCENES)
def test_sample_source_on_the_host_matches_plain(host_model, double_trig,
                                                 name):
    """``env_sample``, run on the host a lane at a time, gives the plain
    twin's bits on every lane: wi, the pdf (0 where the sample's density
    is not > 0, huge at a pole) and the radiance."""
    sc = _scene(name)
    u = _us(sc, N_HOST, 12)
    got = [torch.full((N_HOST, 3), -7.0), torch.full((N_HOST,), -7.0),
           torch.full((N_HOST, 3), -7.0)]
    host_model.host_env_sample(
        u.data_ptr(), *_ptrs(sc, env_cu.SAMPLE_FIELDS), N_HOST, *_sizes(sc),
        *(g.data_ptr() for g in got))
    want = lt.env_sample_plain(sc, u)
    for key, g, w in zip(("wi", "pdf", "le"), got, want):
        assert torch.equal(g, w), key
    ok = want[1] > 0
    assert ok.any() == (name != "cornell")
    if name in ("pow2", "tall"):  # u[1] = 1 picks a zero-integral row
        assert not ok.all()


# ------------------------------------------------------- calls a render
def _spy_calls(monkeypatch):
    """Spies on the wrappers: the calls by kind, and whether each handed
    the kernel what it takes (a contiguous float32 (N, 3) or (N, 2))."""
    calls, refused = collections.Counter(), []
    real_eval, real_sample = env_cu.env_eval, env_cu.env_sample

    def taken(x, width):
        return (x.dtype is torch.float32 and x.dim() == 2
                and x.shape[1] == width and x.is_contiguous())

    def spy_eval(sc, d, le=True, pdf=False):
        calls["env_eval"] += 1
        calls["with_pdf"] += pdf
        if not taken(d, 3):
            refused.append(("eval", d.shape, d.stride()))
        return real_eval(sc, d, le=le, pdf=pdf)

    def spy_sample(sc, u):
        calls["env_sample"] += 1
        if not taken(u, 2):
            refused.append(("sample", u.shape, u.stride()))
        return real_sample(sc, u)

    monkeypatch.setattr(env_cu, "env_eval", spy_eval)
    monkeypatch.setattr(env_cu, "env_sample", spy_sample)
    return calls, refused


@pytest.mark.parametrize("scene", ["tankfarm", "cornell"])
def test_band_frame_calls(monkeypatch, scene):
    """A band-frame of the tank farm at depth 15 (one-sample MIS) makes 16
    ``env_eval`` calls, 15 of them with the pdf, and 15 ``env_sample``
    calls, each on inputs the kernel takes; cornell makes none."""
    path = dict(tankfarm=TANKFARM, cornell=CORNELL)[scene]
    cam, sd, _ = load_mitsuba(path, resolution=(12, 8), device="cpu")
    calls, refused = _spy_calls(monkeypatch)
    before = dict(pint.GRAPH_COUNTS)
    PathIntegrator(PathConfig(max_depth=15, mis_mode="onesample"),
                   spp=2).render(cam, TracedScene.create(sd))
    frames = pint.GRAPH_COUNTS["eager"] - before["eager"]
    assert frames == 2 and not refused
    if scene == "cornell":
        assert not calls
    else:
        assert calls == dict(env_eval=BAND_FRAME["env_eval"] * frames,
                             with_pdf=15 * frames,
                             env_sample=BAND_FRAME["env_sample"] * frames)


def test_light_tracer_hands_the_kernels_what_they_take(monkeypatch):
    """The light tracer's emission sample (``sample_le``) on the tank farm
    reaches the wrapper with inputs the kernel takes."""
    from pathtracer_tpu_torch.integrator_lt import LightTracer

    cam, sd, _ = load_mitsuba(TANKFARM, resolution=(12, 8), device="cpu")
    calls, refused = _spy_calls(monkeypatch)
    LightTracer(PathConfig(max_depth=3), paths=1 << 10,
                wave=1 << 9).render(cam, sd)
    assert calls["env_sample"] > 0 and not refused


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("case", [
    dict(), dict(mis_mode="ref"), dict(light_strategy="all"),
    dict(max_depth=2), dict(mis_mode="ref", light_strategy="all"),
    dict(scene="config_d"), dict(scene="config_d", mis_mode="ref"),
    dict(scene="cornell"), dict(scene="small_scene")],
    ids=["onesample", "ref", "all_lights", "depth2", "ref_all",
         "config_d", "config_d_ref", "cornell", "config_b"])
def test_chip_smoke_counts_a_renders_env_calls(monkeypatch, case):
    """``chip_smoke.env_launches``, which every main path's timed renders
    on the card hold K8's launches to, gives the wrapper calls a render
    makes: MIS modes, light strategies, depths, the tank farm, config D
    (the environment beside Disney spheres) and scenes without an
    environment (none)."""
    smoke = _smoke()
    case = dict(case)
    name = case.pop("scene", "tankfarm")
    if name == "tankfarm":
        cam, sd, _ = load_mitsuba(TANKFARM, resolution=(12, 8),
                                  device="cpu")
    elif name == "cornell":
        cam, sd, _ = load_mitsuba(CORNELL, resolution=(12, 8), device="cpu")
    else:
        make = {"config_d": "envmap_disney_scene"}.get(name, name)
        cam, sd = getattr(procedural, make)((12, 8), device="cpu")
    calls, refused = _spy_calls(monkeypatch)
    integ = PathIntegrator(PathConfig(**{**dict(max_depth=5,
                                                mis_mode="onesample"),
                                         **case}), spp=2)
    scene = TracedScene.create(sd)
    integ.render(cam, scene)
    want = smoke.env_launches(integ, cam, scene)
    assert dict(env_eval=calls["env_eval"],
                env_sample=calls["env_sample"]) == want and not refused
    assert (want["env_eval"] > 0) == bool(scene.has_env)


# ---------------------------------------------------------------- card
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with "
                    "no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, N_CARD])
@pytest.mark.parametrize("name", SCENES)
def test_kernels_match_plain(dev, name, n):
    """K8 ``torch.equal`` to the plain twins on the card, one launch a
    call: every direction's radiance, pdf and both, and every u's sample,
    on the edge cases and seeded lanes."""
    sc = _scene(name, dev)
    d = _directions(sc, max(n, 64), 21)[:n]
    u = _us(sc, max(n, 128), 22)[:n]
    for le, pdf in ((True, False), (False, True), (True, True)):
        before = env_cu.LAUNCHES["env_eval"]
        got = env_cu.env_eval(sc, d, le=le, pdf=pdf)
        assert env_cu.LAUNCHES["env_eval"] == before + 1
        want = lt.env_eval_plain(sc, d, le=le, pdf=pdf)
        for g, w in zip(got, want):
            assert g is None or (g.is_contiguous() and torch.equal(g, w)), \
                (le, pdf)
    before = env_cu.LAUNCHES["env_sample"]
    got = env_cu.env_sample(sc, u)
    assert env_cu.LAUNCHES["env_sample"] == before + 1
    for key, g, w in zip(("wi", "pdf", "le"), got,
                         lt.env_sample_plain(sc, u)):
        assert torch.equal(g, w), key


@pytest.mark.cuda
def test_card_inputs_the_kernels_cannot_take_raise(dev):
    """On the card: a direction of the wrong width or not contiguous,
    float64 u, inputs on two devices, tables that do not fit each other,
    or a float has_env raise before any launch."""
    sc = _scene("odd", dev)
    before = dict(env_cu.LAUNCHES)
    with pytest.raises(ValueError, match="shapes"):
        env_cu.env_eval(sc, torch.zeros((8, 4), device=dev))
    with pytest.raises(TypeError, match="float32"):
        env_cu.env_sample(sc, torch.zeros((8, 2), device=dev,
                                          dtype=torch.float64))
    with pytest.raises(ValueError, match="expected"):
        env_cu.env_eval(sc, torch.zeros((8, 3)))
    broken = types.SimpleNamespace(**{**vars(sc), "env_cond_cdf":
                                      sc.env_cond_cdf[:, :-1].contiguous()})
    with pytest.raises(ValueError, match="shapes"):
        env_cu.env_sample(broken, torch.zeros((8, 2), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        env_cu.env_eval(sc, torch.zeros((3, 8), device=dev).t())
    flag = types.SimpleNamespace(**{**vars(sc), "has_env":
                                    torch.tensor(1.0, device=dev)})
    with pytest.raises(TypeError, match="has_env"):
        env_cu.env_eval(flag, torch.zeros((8, 3), device=dev))
    assert env_cu.LAUNCHES == before


def _render(dev, path, mode, monkeypatch):
    """Two 96 x 72 jobs at 8 spp in chunks of 4, depth 15, through one
    integrator: (films, band-frames, K8 launches, replays). ``mode``:
    "graph" (replays), "eager" (the engagement test refuses), "plain"
    (eager, the environment through the plain twins)."""
    cam, sd, _ = load_mitsuba(path, resolution=(96, 72), device=dev)
    integ = PathIntegrator(PathConfig(max_depth=15, mis_mode="onesample"),
                           spp=8, band_rows=24)
    with monkeypatch.context() as mp:
        if mode != "graph":
            mp.setattr(pint, "_graph_engages", lambda scene, cfg: False)
        if mode == "plain":
            mp.setattr(env_cu, "env_eval", lt.env_eval_plain)
            mp.setattr(env_cu, "env_sample", lt.env_sample_plain)
        scene = TracedScene.create(sd)
        before = dict(pint.GRAPH_COUNTS)
        launches = dict(env_cu.LAUNCHES)
        films = []
        for shift in (0.0, 0.05):
            c2w = cam.cam_to_world.copy()
            c2w[0, 3] += shift
            camera = dataclasses.replace(cam, cam_to_world=c2w)
            films.append(integ.render_progressive(camera, scene,
                                                  chunk_spp=4).cpu())
    frames = sum(v - before[k] for k, v in pint.GRAPH_COUNTS.items())
    return dict(films=films, frames=frames,
                launches={k: v - launches[k]
                          for k, v in env_cu.LAUNCHES.items()},
                replays=pint.GRAPH_COUNTS["replays"] - before["replays"])


@pytest.mark.cuda
def test_tankfarm_films_equal_across_paths_and_the_plain_twins(
        dev, monkeypatch):
    """The tank farm's films of graph replay, of the eager loop and of the
    eager loop with the plain twins are ``torch.equal``; K8 launches 16
    ``env_eval`` + 15 ``env_sample`` a band-frame on the two K8 paths (a
    replay counts its capture's tally) and none on the plain one."""
    runs = {mode: _render(dev, TANKFARM, mode, monkeypatch)
            for mode in ("graph", "eager", "plain")}
    assert runs["graph"]["replays"] > 0 and runs["eager"]["replays"] == 0
    want = runs["plain"]["films"]
    assert not torch.equal(want[0], want[1])
    for mode in ("graph", "eager"):
        for got, ref in zip(runs[mode]["films"], want):
            assert torch.isfinite(got).all() and (got[..., 3] > 0).all()
            assert torch.equal(got, ref), mode
        frames = runs[mode]["frames"]
        assert runs[mode]["launches"] == {
            k: v * frames for k, v in BAND_FRAME.items()}, mode
    assert runs["plain"]["launches"] == dict(env_eval=0, env_sample=0)


@pytest.mark.cuda
def test_cornell_launches_none(dev, monkeypatch):
    """Cornell has no environment: its band-frames launch no K8."""
    run = _render(dev, CORNELL, "graph", monkeypatch)
    assert run["frames"] > 0
    assert run["launches"] == dict(env_eval=0, env_sample=0)
