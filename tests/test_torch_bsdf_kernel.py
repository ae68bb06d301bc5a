"""Kernels K5 (``bsdf_cu.bsdf_eval``) and K6 (``bsdf_cu.bsdf_sample``).

On the CPU each wrapper runs its plain version (``ops/bsdf.eval_world``,
``ops/bsdf.sample_world``: ``eval_f_pdf`` and ``sample_f`` with the frame
changes around them); these tests check that, the source's material
constants against the Python ones, the material sets of the scenes in the
tree (the ``present`` masks the card cases cover), the plain versions
against ``eval_f_pdf`` / ``sample_f`` in an identity frame, and the
kernels' own arithmetic: the
source is compiled for the host with the host C++ compiler (a shim stands
in for the CUDA runtime, a thread a lane in a loop; ``cosf`` / ``sinf``
taken as the double-precision function rounded once, on both sides, since
the host's float versions differ from PyTorch's CPU ones) and held to the
plain versions bit for bit on every lane.

The ``cuda``-marked tests hold each kernel to its plain version on the
card with ``torch.equal`` on every output: each of the seven material
types alone and mixed, every ``present`` set the tree's scenes use and
all seven, lanes whose type is outside ``present``, ``wo.z == 0``, total
internal reflection and grazing ``wi``; the launch counts, a CUDA graph's
capture and replays; and two films: the light tracer on cornell and the
path integrator on the spheres, each ``torch.equal`` to the same render
through the plain functions. They skip here: a CUDA kernel has no CPU or
interpret mode. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_bsdf_kernel.py
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import bsdf as bx
from pathtracer_tpu_torch.ops.cuda import _build, bsdf_cu
from pathtracer_tpu_torch.scene import scene as pscene
from pathtracer_tpu_torch.scene.scene import (MAT_DISNEY, MAT_GLASS,
                                              MAT_MATTE, MAT_METAL,
                                              MAT_MIRROR, MAT_ROUGHGLASS,
                                              MAT_SUBSTRATE)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N = 4099  # ragged: not a multiple of the kernels' block
N_HOST = 1031  # the host model's lanes (a lane at a time: slower)
TYPES = bx.ALL_MATERIALS
# the material sets of the scenes in the tree (TracedScene.mat_set),
# checked against the scenes in test_scene_material_sets
SCENE_SETS = {
    "cornell / box field": (MAT_MATTE,),
    "config B": (MAT_MATTE, MAT_MIRROR, MAT_GLASS),
    "config C / cornell-spheres": (MAT_MATTE, MAT_GLASS, MAT_METAL,
                                   MAT_SUBSTRATE),
    "config D": (MAT_MATTE, MAT_DISNEY),
    "feature scene": (MAT_MATTE, MAT_MIRROR, MAT_GLASS, MAT_METAL,
                      MAT_SUBSTRATE, MAT_ROUGHGLASS),
    "classroom / sponza": (MAT_DISNEY,),
}
PRESENTS = list(SCENE_SETS.values()) + [TYPES]
PRESENT_IDS = list(SCENE_SETS) + ["all"]


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _frames(rng, n):
    """Random orthonormal shading frames (ss, ts, ns) and geometric
    normals ng (ns itself on half the lanes)."""
    ns = _unit(rng, n).astype(np.float64)
    ss = np.cross(ns, _unit(rng, n))
    ss /= np.linalg.norm(ss, axis=1, keepdims=True)
    ts = np.cross(ns, ss)
    ng = np.where(rng.random((n, 1)) < 0.5, ns, _unit(rng, n))
    return [x.astype(np.float32) for x in (ss, ts, ns, ng)]


def _inputs(seed, n, types, device="cpu"):
    """Seeded lanes of ``types``: the material parameters as
    ``gather_params`` gives them (column slices of (N, MA_WIDTH) rows; ax
    and ay contiguous, isotropic on half the lanes), the hits' frames
    (``it``: ss, ts, ns, ng), world wo and wi on the sphere and u in [0,
    1)^2. Edge lanes, in the identity frame so that their local
    directions are the ones given: wo.z == 0, wo at either pole, wi
    grazing, wo inside glass at grazing angles (total internal
    reflection), u on the lobe picks' boundaries."""
    rng = np.random.default_rng(seed)
    rows = rng.random((n, pscene.MA_WIDTH)).astype(np.float32)
    rows[:, pscene.MA_ETA] = rng.uniform(1.1, 2.5, (n, 3))
    rows[:, pscene.MA_K] = rng.uniform(0.0, 4.0, (n, 3))
    mtype = rng.choice(np.asarray(types, np.int32), n)
    ax = np.exp(rng.uniform(np.log(1e-3), 0.0, n)).astype(np.float32)
    ay = np.where(rng.random(n) < 0.5, ax,
                  np.exp(rng.uniform(np.log(1e-3), 0.0, n))).astype(
                      np.float32)
    frame = _frames(rng, n)
    edge = slice(0, 96)
    for x, axis in zip(frame, (0, 1, 2, 2)):
        x[edge] = np.eye(3, dtype=np.float32)[axis]
    wo, wi = _unit(rng, n), _unit(rng, n)
    wo[0:8, 2] = 0.0
    wo[8:16] = (0.0, 0.0, 1.0)
    wo[16:24] = (0.0, 0.0, -1.0)
    wi[24:32, 2] = 1e-7
    wo[32:40] = (0.6, 0.8, 0.0)
    wo[64:96] = (0.95, 0.0, -np.sqrt(1.0 - 0.95 ** 2))
    u = rng.random((n, 2)).astype(np.float32)
    u[40:48, 0] = 0.5
    u[48:56, 0] = 0.0
    u[56:64] = 0.5

    def t(a):
        return torch.as_tensor(a, device=device)

    r = t(rows)
    mp = dict(mtype=t(mtype), kd=r[:, pscene.MA_KD], ks=r[:, pscene.MA_KS],
              eta3=r[:, pscene.MA_ETA], eta=r[:, pscene.MA_ETA][:, 0],
              k=r[:, pscene.MA_K], ax=t(ax), ay=t(ay),
              metallic=r[:, pscene.MA_MISC][:, 0])
    it = {k: t(x) for k, x in zip(("ss", "ts", "ns", "ng"), frame)}
    return mp, it, t(wo), t(wi), t(u)


SAMPLE_KEYS = ("wi", "f", "pdf", "specular", "transmission", "cos")


# ---------------------------------------------------------------- CPU
@pytest.mark.parametrize("present", PRESENTS, ids=PRESENT_IDS)
def test_cpu_calls_are_the_plain_versions(present):
    """CPU tensors take the plain versions and launch nothing."""
    mp, it, wo, wi, u = _inputs(3, 257, TYPES)
    before = dict(bsdf_cu.LAUNCHES)
    got = bsdf_cu.bsdf_eval(mp, it, wo, wi, present=present)
    want = bx.eval_world(mp, it, wo, wi, present=present)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = bsdf_cu.bsdf_sample(mp, it, wo, u, present=present)
    want = bx.sample_world(mp, it, wo, u, present=present)
    for key in SAMPLE_KEYS:
        assert torch.equal(got[key], want[key]), key
    assert bsdf_cu.LAUNCHES == before


def test_source_constants_match_the_python_layout():
    """The source's material types are scene.py's; a launcher's
    parameters are as many as its signature's letters."""
    with open(os.path.join(_build.CSRC_DIR, bsdf_cu.SOURCE)) as fh:
        src = fh.read()
    for name in ("MAT_MATTE", "MAT_MIRROR", "MAT_GLASS", "MAT_METAL",
                 "MAT_SUBSTRATE", "MAT_DISNEY", "MAT_ROUGHGLASS"):
        got = int(re.search(rf"#define {name} (\d+)", src).group(1))
        assert got == getattr(pscene, name), name
    assert int(re.search(r"#define N_MATERIALS (\d+)", src).group(1)) == \
        len(TYPES)
    mat = re.search(r"#define MAT_PARAMS(.*?)\n#define", src, re.S).group(1)
    frame = re.search(r"#define FRAME_PARAMS(.*?)\n\n", src, re.S).group(1)
    n_in = mat.count(",") + frame.count(",") + 2
    for kernel, sig in bsdf_cu.SIGNATURES.items():
        body = re.search(
            rf"pt_{kernel}_launch\(MAT_PARAMS, FRAME_PARAMS,(.*?)\)", src,
            re.S).group(1)
        assert n_in + body.count(",") + 1 == len(sig), kernel


def test_scene_material_sets():
    """SCENE_SETS are the material sets of the scenes in the tree."""
    from pathtracer_tpu_torch.scene import procedural
    from pathtracer_tpu_torch.scene.gltf import load_gltf
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
    from torch_mitsuba_scenes import write_feature_scene

    def mats(sd):  # TracedScene.create's mat_set, without its BVH build
        used = np.unique(sd.material_id.cpu().numpy())
        return tuple(sorted(set(sd.mat_type.cpu().numpy()[used].tolist())))

    def proc(name, **kw):
        return mats(getattr(procedural, name)((8, 8), device="cpu", **kw)[1])

    def xml(path):
        return mats(load_mitsuba(path, resolution=(8, 8), device="cpu")[1])

    def glb(path):
        return mats(load_gltf(path, resolution=(8, 8), device="cpu")[1])

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        feature = xml(write_feature_scene(tmp))
    found = {
        "cornell / box field": {xml(os.path.join(ROOT, "data",
                                                 "cornell-box.xml")),
                                proc("box_field_scene", n_boxes=50)},
        "config B": {proc("small_scene")},
        "config C / cornell-spheres": {
            proc("microfacet_scene"),
            xml(os.path.join(ROOT, "benchmark", "scenes",
                             "cornell-spheres.xml"))},
        "config D": {proc("envmap_disney_scene")},
        "feature scene": {feature},
        "classroom / sponza": {
            glb(os.path.join(ROOT, "data", "classroom_proc.glb")),
            glb(os.path.join(ROOT, "data", "sponza_proc.glb"))},
    }
    assert found == {k: {v} for k, v in SCENE_SETS.items()}


@pytest.mark.parametrize("present", PRESENTS, ids=PRESENT_IDS)
def test_world_versions_are_the_local_ones_in_their_frame(present):
    """In the identity frame (ng = ns = z) the world versions give
    ``eval_f_pdf`` and ``sample_f`` of the same directions bit for bit,
    with reflect_ng = (wi.z)(wo.z) > 0 and cos = |wi.z|; in random
    orthonormal frames, sample_world's wi is sample_f's taken to world
    space."""
    mp, it, wo, wi, u = _inputs(9, 513, TYPES)
    eye = {k: torch.zeros_like(wo) for k in it}
    for k, axis in zip(("ss", "ts", "ns", "ng"), (0, 1, 2, 2)):
        eye[k][:, axis] = 1.0
    refl = wi[:, 2] * wo[:, 2] > 0.0
    f, pdf, cos = bx.eval_world(mp, eye, wo, wi, present=present)
    wf, wpdf = bx.eval_f_pdf(mp, wo, wi, refl, present=present)
    assert torch.equal(f, wf) and torch.equal(pdf, wpdf)
    assert torch.equal(cos, wi[:, 2].abs())
    got = bx.sample_world(mp, eye, wo, u, present=present)
    want = bx.sample_f(mp, wo, u, lambda w: w[:, 2] * wo[:, 2] > 0.0,
                       present=present)
    for key in ("wi", "f", "pdf", "specular", "transmission"):
        assert torch.equal(got[key], want[key]), key
    got = bx.sample_world(mp, it, wo, u, present=present)
    local = bx.sample_f(mp, bx.to_local(it, wo), u,
                        bx.reflect_ng_test(it, wo), present=present)
    assert torch.equal(got["wi"], bx.to_world(it, local["wi"]))
    np.testing.assert_allclose(
        bx.to_world(it, bx.to_local(it, wo)).numpy(), wo.numpy(),
        atol=1e-6)


def test_scene_flags():
    """``present`` as a bit mask; ``pt::bsdf:kernel`` where METAL,
    SUBSTRATE or GLASS is present."""
    assert bsdf_cu._scene_flags(()) == (0, False)
    assert bsdf_cu._scene_flags((MAT_MATTE,)) == (1, False)
    assert bsdf_cu._scene_flags(SCENE_SETS["config C / cornell-spheres"]) \
        == (0b11101, True)
    assert bsdf_cu._scene_flags(SCENE_SETS["config D"]) == (0b100001, False)
    assert bsdf_cu._scene_flags(TYPES) == (0b1111111, True)


# the host model of the kernels: a stand-in for the CUDA runtime, the
# source up to the end of its anonymous namespace, and one C function a
# kernel that runs its body for each lane
_SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct host_dim3 { unsigned x, y, z; };
static host_dim3 blockIdx, threadIdx;
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline float host_cosf(float x) { return (float)cos((double)x); }
static inline float host_sinf(float x) { return (float)sin((double)x); }
#define cosf host_cosf
#define sinf host_sinf
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
extern "C" void host_eval(MAT_PARAMS, FRAME_PARAMS, const float* wo,
                          const float* wi, int present, int n, float* f,
                          float* pdf, float* cosine) {
  const Mat m = make_mat(MAT_ARGS);
  const Frame fr = make_frame(ss, ts, ns, ng);
  LANES(bsdf_eval_kernel(m, fr, wo, wi, present, n, f, pdf, cosine));
}
extern "C" void host_sample(MAT_PARAMS, FRAME_PARAMS, const float* wo,
                            const float* u, int present, int n, float* wi,
                            float* f, float* pdf, uint8_t* spec,
                            uint8_t* trans, float* cosine) {
  const Mat m = make_mat(MAT_ARGS);
  const Frame fr = make_frame(ss, ts, ns, ng);
  LANES(bsdf_sample_kernel(m, fr, wo, u, present, n, wi, f, pdf, spec,
                           trans, cosine));
}
"""


@pytest.fixture(scope="module")
def host_model(tmp_path_factory):
    """csrc/bsdf.cu compiled for the host with ``c++`` (its launchers
    left out: the rest is plain C++ under the shim)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("bsdf_host")
    (tmp / "cuda_runtime.h").write_text(_SHIM)
    with open(os.path.join(_build.CSRC_DIR, bsdf_cu.SOURCE)) as fh:
        src = fh.read()
    cut = src.index("}  // namespace")
    # the parameter macros and make_frame, between the namespace and K5
    macros = src[src.index("#define MAT_PARAMS"):src.index("// K5:")]
    (tmp / "model.cpp").write_text(src[:cut] + macros + _LANE_LOOP)
    lib = tmp / "libbsdf_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", f"-I{tmp}", "-w",
                    "-o", str(lib), str(tmp / "model.cpp")], check=True,
                   capture_output=True)
    model = ctypes.CDLL(str(lib))
    arg = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for name, kernel in (("host_eval", "bsdf_eval"),
                         ("host_sample", "bsdf_sample")):
        getattr(model, name).argtypes = [
            arg[c] for c in bsdf_cu.SIGNATURES[kernel][:-1]]
    return model


def _mat_args(mp, it):
    """The launchers' material and frame arguments (as bsdf_cu passes
    them)."""
    out = []
    for key in ("mtype", "kd", "ks", "eta", "eta3", "k", "ax", "ay",
                "metallic"):
        out.append(mp[key].data_ptr())
        out.extend(mp[key].stride())
    return out + [it[k].data_ptr() for k in bsdf_cu.FRAME]


@pytest.fixture
def double_trig(monkeypatch):
    """torch.cos / torch.sin in float64 rounded once, as the host model
    takes cosf / sinf."""
    cos, sin = torch.cos, torch.sin
    monkeypatch.setattr(torch, "cos", lambda x: cos(x.double()).float())
    monkeypatch.setattr(torch, "sin", lambda x: sin(x.double()).float())


@pytest.mark.parametrize("only", [None] + list(TYPES),
                         ids=["mixed"] + [f"type{t}" for t in TYPES])
@pytest.mark.parametrize("present", PRESENTS, ids=PRESENT_IDS)
def test_kernel_source_on_the_host_matches_plain(host_model, double_trig,
                                                 present, only):
    """The kernels' arithmetic, run on the host a lane at a time, gives
    the plain versions' bits on every lane and output."""
    types = TYPES if only is None else (only,)
    n = N_HOST
    mp, it, wo, wi, u = _inputs(11 + (only or 0), n, types)
    mask = bsdf_cu._scene_flags(present)[0]
    got = [torch.empty(n, 3), torch.empty(n), torch.empty(n)]
    host_model.host_eval(*_mat_args(mp, it), wo.data_ptr(), wi.data_ptr(),
                         mask, n, *(x.data_ptr() for x in got))
    want = bx.eval_world(mp, it, wo, wi, present=present)
    for name, g, w in zip(("f", "pdf", "cos"), got, want):
        assert torch.equal(g, w), name
    got = dict(wi=torch.empty(n, 3), f=torch.empty(n, 3), pdf=torch.empty(n),
               specular=torch.empty(n, dtype=torch.bool),
               transmission=torch.empty(n, dtype=torch.bool),
               cos=torch.empty(n))
    host_model.host_sample(*_mat_args(mp, it), wo.data_ptr(), u.data_ptr(),
                           mask, n, *(got[k].data_ptr() for k in SAMPLE_KEYS))
    want = bx.sample_world(mp, it, wo, u, present=present)
    for key in SAMPLE_KEYS:
        assert torch.equal(got[key], want[key]), key


# ---------------------------------------------------------------- card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _both(mp, it, wo, wi, u, present):
    """(kernel, plain) results on the card: eval's f, pdf, cos, then
    sample's wi, f, pdf, specular, transmission, cos."""
    before = dict(bsdf_cu.LAUNCHES)
    got = bsdf_cu.bsdf_eval(mp, it, wo, wi, present=present)
    bs = bsdf_cu.bsdf_sample(mp, it, wo, u, present=present)
    torch.cuda.synchronize()
    assert bsdf_cu.LAUNCHES == dict(bsdf_eval=before["bsdf_eval"] + 1,
                                    bsdf_sample=before["bsdf_sample"] + 1)
    want = bx.eval_world(mp, it, wo, wi, present=present)
    ps = bx.sample_world(mp, it, wo, u, present=present)
    return (list(got) + [bs[k] for k in SAMPLE_KEYS],
            list(want) + [ps[k] for k in SAMPLE_KEYS])


NAMES = ("eval f", "eval pdf", "eval cos") + SAMPLE_KEYS


@pytest.mark.cuda
@pytest.mark.parametrize("only", [None] + list(TYPES),
                         ids=["mixed"] + [f"type{t}" for t in TYPES])
@pytest.mark.parametrize("present", PRESENTS, ids=PRESENT_IDS)
def test_kernels_match_plain(dev, present, only):
    """K5 and K6 ``torch.equal`` to the plain versions on the card, one
    launch each a call: each type alone and all mixed, under every
    scene's ``present`` (lanes of other types included), with the edge
    lanes of ``_inputs``."""
    types = TYPES if only is None else (only,)
    got, want = _both(*_inputs(11 + (only or 0), N, types, dev), present)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 131072])
def test_kernels_match_plain_at_any_width(dev, n):
    """Ragged and full-wave widths, all types, all present."""
    got, want = _both(*_inputs(n, n, TYPES, dev), TYPES)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
def test_edge_lanes_are_covered(dev):
    """The edge lanes do what they were made for in the plain version:
    glass lanes under total internal reflection (all reflected), wo.z ==
    0 lanes zero in eval, and the kernel agrees there."""
    got, want = _both(*_inputs(2, 128, (MAT_GLASS,), dev), TYPES)
    tir = slice(64, 96)
    pdf, trans = want[NAMES.index("pdf")], want[NAMES.index("transmission")]
    assert bool((trans[tir] == 0).all()) and bool((pdf[tir] == 1).all())
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    mp, it, wo, wi, u = _inputs(2, 128, (MAT_MATTE,), dev)
    f, pdf, _ = bsdf_cu.bsdf_eval(mp, it, wo, wi, present=TYPES)
    assert not f[0:8].any() and not pdf[0:8].any()


@pytest.mark.cuda
def test_launches_count_and_a_graph_replays_them(dev):
    """Each call counts one launch; inside a CUDA graph's capture the
    launches are tallied and not counted, and each replay counts the
    tally and gives the eager results."""
    mp, it, wo, wi, u = _inputs(4, 1024, TYPES, dev)
    present = SCENE_SETS["feature scene"]

    def call():
        return (bsdf_cu.bsdf_eval(mp, it, wo, wi, present=present),
                bsdf_cu.bsdf_sample(mp, it, wo, u, present=present))

    eager = call()
    torch.cuda.synchronize()
    before = dict(bsdf_cu.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), _build.capturing() as tally:
        with torch.cuda.graph(graph, stream=stream):
            out = call()
    torch.cuda.current_stream().wait_stream(stream)
    assert tally == dict(bsdf_eval=1, bsdf_sample=1)
    assert bsdf_cu.LAUNCHES == before
    for _ in range(3):
        graph.replay()
        _build.replayed(tally)
    torch.cuda.synchronize()
    assert bsdf_cu.LAUNCHES == {k: v + 3 for k, v in before.items()}
    for g, e in zip(out[0], eager[0]):
        assert torch.equal(g, e)
    for key in SAMPLE_KEYS:
        assert torch.equal(out[1][key], eager[1][key]), key


@pytest.mark.cuda
def test_empty_and_bad_inputs(dev):
    """N = 0 launches nothing; int64 types, a strided wo, a CPU wi with
    card lanes and a strided frame raise."""
    mp, it, wo, wi, u = _inputs(6, 64, TYPES, dev)
    before = dict(bsdf_cu.LAUNCHES)
    empty = {k: v[:0] for k, v in mp.items()}
    it0 = {k: v[:0] for k, v in it.items()}
    f, pdf, cos = bsdf_cu.bsdf_eval(empty, it0, wo[:0], wi[:0])
    assert f.shape == (0, 3) and pdf.shape == cos.shape == (0,)
    bs = bsdf_cu.bsdf_sample(empty, it0, wo[:0], u[:0])
    assert bs["wi"].shape == (0, 3) and bsdf_cu.LAUNCHES == before
    with pytest.raises(TypeError, match="int32"):
        bsdf_cu.bsdf_eval(dict(mp, mtype=mp["mtype"].long()), it, wo, wi)
    wide = torch.zeros((64, 4), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        bsdf_cu.bsdf_eval(mp, it, wide[:, :3], wi)
    with pytest.raises(ValueError, match="contiguous"):
        bsdf_cu.bsdf_sample(mp, dict(it, ns=wide[:, 1:]), wo, u)
    with pytest.raises(ValueError):
        bsdf_cu.bsdf_eval(mp, it, wo, wi.cpu())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("present", [(MAT_MATTE,), SCENE_SETS[
    "config C / cornell-spheres"]], ids=["cornell", "spheres"])
def test_launches_lie_in_their_spans(dev, present):
    """Under the profiler each kernel's launch lies in its
    ``pt::k:bsdf_*`` span, inside one ``pt::bsdf:kernel`` span where
    METAL, SUBSTRATE or GLASS is present and in none otherwise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mp, it, wo, wi, u = _inputs(8, 512, TYPES, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bsdf_cu.bsdf_eval(mp, it, wo, wi, present=present)
        bsdf_cu.bsdf_sample(mp, it, wo, u, present=present)
        torch.cuda.synchronize()
    spans, runtime, kernels = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("pt::"):
                spans.append((e.name(), e.start_ns(), e.end_ns()))
            elif e.name().startswith("cu"):
                runtime[e.correlation_id()] = e.start_ns()
        elif "bsdf_" in e.name() and not e.is_user_annotation():
            kernels.append((e.name(), e.correlation_id()))
    assert len(kernels) == 2
    spanned = bsdf_cu._scene_flags(present)[1]
    for name, corr in kernels:
        t = runtime[corr]
        held = [n for n, s, x in sorted(spans, key=lambda s: s[1])
                if s <= t <= x]
        what = "bsdf_eval" if "bsdf_eval" in name else "bsdf_sample"
        assert held[-1] == "pt::k:" + what, held
        assert held[:-1] == (["pt::bsdf:kernel"] if spanned else []), held


def _plain_wrappers(monkeypatch):
    """Route the integrators' calls to the plain versions (the card runs
    them as eager PyTorch ops)."""
    monkeypatch.setattr(bsdf_cu, "bsdf_eval", bx.eval_world)
    monkeypatch.setattr(bsdf_cu, "bsdf_sample", bx.sample_world)


@pytest.mark.cuda
def test_light_tracer_film_equals_the_plain_functions_film(dev, monkeypatch):
    """The light tracer on cornell through K5 / K6 and through the plain
    functions: equal films, and the kernels launched on its path."""
    from pathtracer_tpu_torch.integrator import PathConfig
    from pathtracer_tpu_torch.integrator_lt import LightTracer
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(os.path.join(ROOT, "data", "cornell-box.xml"),
                              resolution=(64, 48), device=dev)
    lt = LightTracer(PathConfig(max_depth=5), paths=1 << 17, wave=1 << 16)
    before = dict(bsdf_cu.LAUNCHES)
    got = lt.render(cam, sd)
    torch.cuda.synchronize()
    assert bsdf_cu.LAUNCHES["bsdf_eval"] == before["bsdf_eval"] + 2 * 5
    assert bsdf_cu.LAUNCHES["bsdf_sample"] == before["bsdf_sample"] + 2 * 4
    _plain_wrappers(monkeypatch)
    want = lt.render(cam, sd)
    assert torch.isfinite(got).all() and got[..., :3].any()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_spheres_film_equals_the_plain_functions_film(dev, monkeypatch):
    """The path integrator on cornell-spheres (depth 15, Sobol, one-sample
    MIS; graph replay) through K5 / K6 and through the plain functions:
    equal films. Russian roulette after a glass bounce turns on beta's
    last bit, so a one-ulp gap anywhere would show."""
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(os.path.join(ROOT, "benchmark", "scenes",
                                           "cornell-spheres.xml"),
                              resolution=(96, 72), device=dev)
    scene = TracedScene.create(sd)
    cfg = PathConfig(max_depth=15, mis_mode="onesample")
    before = dict(bsdf_cu.LAUNCHES)
    got = PathIntegrator(cfg, spp=4).render(cam, scene)
    torch.cuda.synchronize()
    assert bsdf_cu.LAUNCHES["bsdf_eval"] > before["bsdf_eval"]
    _plain_wrappers(monkeypatch)
    want = PathIntegrator(cfg, spp=4).render(cam, scene)
    assert torch.isfinite(got).all() and (got[..., 3] > 0).all()
    assert torch.equal(got, want)
