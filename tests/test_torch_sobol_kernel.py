"""Kernel K7 (``sobol_cu.sobol_index`` and the draws
``sobol_cu.sobol_sample_dim`` / ``sobol_sample_dim2``).

On the CPU each wrapper runs its plain function of ``ops/sobol.py`` (the
bit-matrix chain, held to the JAX package's bits in
``test_torch_sobol.py``); these tests check that, the frame words as the
launcher takes them, the source's constants, the draws a band-frame makes,
and the kernel's arithmetic twice: a numpy model of a lane's loop (XOR
the row word of each set index bit, then convert), and the source itself
compiled for the host with the host C++ compiler (a shim stands in for
the CUDA runtime; each block's threads run in a loop, twice, so that the
first round stages the block's shared rows as ``__syncthreads`` would
have them staged), both held to the plain chain bit for bit.

The ``cuda``-marked tests hold K7 to the plain chain on the card with
``torch.equal``: the index at every domain size up to 640 x 480's, frames
whose shifted high word is set, the frame words as host ints and as 0-d
device tensors; every dimension of the table and past it (the clamp), one
and two at a time, scrambled and not; lane counts that are not a multiple
of the block. Then the films of both benchmark configurations: graph
replay, eager, and eager with the plain chain's draws, all equal, with
K7's launches a band-frame. They skip here: a CUDA kernel has no CPU or
interpret mode. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_sobol_kernel.py
"""

import collections
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import integrator as pint
from pathtracer_tpu_torch.core.math import ONE_MINUS_EPSILON
from pathtracer_tpu_torch.ops import sobol as sb
from pathtracer_tpu_torch.ops.cuda import _build, sobol_cu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "benchmark", "scenes", "cornell-box.xml")
SPHERES = os.path.join(ROOT, "benchmark", "scenes", "cornell-spheres.xml")

N = 4099  # ragged: not a multiple of the kernel's block
ROWS = 1024  # the generator table's dimensions
# sample rectangles from one pixel (m = 0) to 640 x 480's (m = 10) and
# the largest the domain takes (m = 16)
DOMAINS = [((0, 0), (1, 1)), ((0, 0), (2, 2)), ((-2, -2), (30, 30)),
           ((-2, -2), (642, 482)), ((0, 0), (1 << 16, 1 << 16))]
# frames; at m = 10 the shifted high word is set from frame 4096 on, at
# m = 16 from frame 1
FRAMES = (0, 1, 3, 63, 4101, (1 << 20) + 7)
# the draws of one band-frame at max_depth 5 (cornell) and 15 (the
# spheres), both scenes with two light triangles under one-sample MIS:
# the index, the camera pair, and a shading bounce's u_light pair, light
# pick and u_bsdf pair, with roulette's draw at bounces above 3
DRAWS = {"cornell": dict(sobol_index=1, sobol_draw=1 + 3 * 5 + 1),
         "spheres": dict(sobol_index=1, sobol_draw=1 + 3 * 15 + 11)}


def _words(seed, n):
    """Seeded 32-bit words (N,) int64 over the whole range."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 1 << 32, n, dtype=np.int64))


def _index_inputs(domain, frame, seed, n=N):
    """b_base of random pixels of ``domain`` (N,) int64, the frame's words
    (delta, shifted lo, shifted hi) as ints and the inverse-vdc rows."""
    dom = sb.SobolDomain.create(*domain, 4)
    rng = np.random.default_rng(seed)
    (x0, y0), (x1, y1) = domain
    px, py = rng.integers(x0, x1, n), rng.integers(y0, y1, n)
    _, b_base = sb.pixel_statics(dom, px, py)
    lo, hi, delta = (int(w) for w in sb.frame_statics(dom, frame))
    return (torch.as_tensor(b_base.astype(np.int64)), (delta, lo, hi),
            sb.vdc_inv_rows(dom, "cpu"))


def _dims():
    """Every dimension of the table, and some past it."""
    return list(range(ROWS)) + [ROWS, ROWS + 1, 2 * ROWS + 5]


# ---------------------------------------------------------------- CPU
@pytest.mark.parametrize("scrambled", [True, False],
                         ids=["scrambled", "unscrambled"])
@pytest.mark.parametrize("k", [1, 2])
def test_cpu_draws_are_the_plain_functions(k, scrambled):
    """CPU tensors take the plain functions and launch nothing; a None
    scramble is the plain function's zero scramble."""
    lo, hi, scr = _words(1, 257), _words(2, 257), _words(3, 257)
    sm32 = sb.sm32_device("cpu")
    plain = sb.sobol_sample_dim if k == 1 else sb.sobol_sample_dim2
    wrapper = (sobol_cu.sobol_sample_dim if k == 1
               else sobol_cu.sobol_sample_dim2)
    before = dict(sobol_cu.LAUNCHES)
    for dim in (0, 2, 7, 500, ROWS - 1, ROWS + 3):
        got = wrapper(lo, hi, dim, scr if scrambled else None, sm32)
        want = plain(lo, hi, dim, scr if scrambled else torch.zeros_like(lo),
                     sm32)
        assert got.shape == ((257,) if k == 1 else (257, 2))
        assert torch.equal(got, want)
    assert sobol_cu.LAUNCHES == before


@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["host_ints", "tensors"])
def test_cpu_index_is_the_plain_function(as_tensors):
    """CPU tensors take the plain ``sobol_index`` (the frame words as host
    ints or 0-d tensors) and launch nothing."""
    b_base, words, inv = _index_inputs(DOMAINS[3], 4101, 5)
    given = [torch.tensor(w, dtype=torch.int64) for w in words] \
        if as_tensors else words
    before = dict(sobol_cu.LAUNCHES)
    got = sobol_cu.sobol_index(b_base, *given, *inv)
    want = sb.sobol_index(b_base, *words, *inv)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sobol_cu.LAUNCHES == before


def test_frame_words_as_the_launcher_takes_them():
    """A host word goes by value, as the C int of its 32 bits; a word out
    of range or a tensor the kernel cannot read raises."""
    for v in (0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1):
        for given in (v, np.uint32(v)):
            ptr, got = sobol_cu._word(given, 0)
            assert ptr == 0 and ctypes.c_uint32(got).value == v
            assert -(1 << 31) <= got < 1 << 31
    for bad in (-1, 1 << 32):
        with pytest.raises(ValueError, match="2\\^32"):
            sobol_cu._word(bad, 0)
    with pytest.raises(ValueError, match="0-d int64"):
        sobol_cu._word(torch.tensor(3), 0)  # on the CPU


def test_inputs_on_another_device_raise():
    """Tensors on a device neither the CPU nor a card (meta tensors: the
    checks read no data) raise before any launch."""
    meta = torch.empty(16, dtype=torch.int64, device="meta")
    table = torch.empty((ROWS, 52), dtype=torch.int64, device="meta")
    for draw in (sobol_cu.sobol_sample_dim, sobol_cu.sobol_sample_dim2):
        with pytest.raises(ValueError, match="cpu or cuda"):
            draw(meta, meta, 0, None, table)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sobol_cu.sobol_index(meta, 0, 0, 0, table[0], table[1])


def test_source_constants_match_the_python_layout():
    """The source's row width, ONE_MINUS_EPSILON and block are the ones
    the wrapper and core/math.py use; a launcher's parameters are as many
    as its signature's letters."""
    with open(os.path.join(_build.CSRC_DIR, sobol_cu.SOURCE)) as fh:
        src = fh.read()
    assert int(re.search(r"#define ROW_WORDS (\d+)", src).group(1)) == \
        sobol_cu.ROW_WORDS == sb.sm32_device("cpu").shape[1]
    assert int(re.search(r"#define INDEX_BITS (\d+)", src).group(1)) == 32
    eps = re.search(r"#define ONE_MINUS_EPSILON (\S+)f", src).group(1)
    assert np.float32(float.fromhex(eps)) == ONE_MINUS_EPSILON
    for kernel, sig in sobol_cu.SIGNATURES.items():
        params = re.search(rf"pt_{kernel}_launch\((.*?)\)", src,
                           re.S).group(1)
        assert params.count(",") + 1 == len(sig), kernel


def _lane_model(lo, hi, rows, scramble):
    """A numpy model of a K7 lane's loop: for each of the 52 index bits (32
    of lo, 20 of hi) XOR the row's word where the bit is set, XOR the
    scramble, then convert as ``_to_unit``. rows (K, 52) -> (N, K)."""
    lo, hi = lo.astype(np.uint32), hi.astype(np.uint32)
    rows = rows.astype(np.uint32)
    v = np.zeros((lo.shape[0], rows.shape[0]), np.uint32)
    for c in range(52):
        bit = (lo >> np.uint32(c)) if c < 32 else (hi >> np.uint32(c - 32))
        mask = np.uint32(0) - (bit & np.uint32(1))
        v ^= rows[:, c][None, :] & mask[:, None]
    v ^= scramble.astype(np.uint32)[:, None]
    unit = v.astype(np.float32) * np.float32(2.0 ** -32)
    return np.minimum(unit, ONE_MINUS_EPSILON)


def _index_model(b_base, words, inv):
    """The numpy model of the index kernel's lane: XOR the inverse-vdc
    words at the set bits of b_base ^ delta, then the shifted words."""
    delta, lo_w, hi_w = (np.uint32(w) for w in words)
    b = b_base.astype(np.uint32) ^ delta
    lo = np.zeros_like(b)
    hi = np.zeros_like(b)
    inv_lo, inv_hi = (x.numpy().astype(np.uint32) for x in inv)
    for c in range(32):
        mask = np.uint32(0) - ((b >> np.uint32(c)) & np.uint32(1))
        lo ^= inv_lo[c] & mask
        hi ^= inv_hi[c] & mask
    return (lo ^ lo_w).astype(np.int64), (hi ^ hi_w).astype(np.int64)


@pytest.mark.parametrize("seed", range(4))
def test_numpy_lane_model_matches_plain(seed):
    """The per-lane model gives the plain chain's bits on random index
    words (hi above its 20 bits set too), random dimensions inside and
    past the table, one and two at a time, random scrambles; and the
    index model the plain ``sobol_index``'s on every domain."""
    rng = np.random.default_rng(seed)
    lo, hi, scr = (_words(10 * seed + j, 1031) for j in range(3))
    sm32 = sb.sm32_device("cpu")
    table = sm32.numpy()
    for dim in rng.integers(0, ROWS + 40, 24).tolist() + [ROWS - 1, ROWS]:
        for k, plain in ((1, sb.sobol_sample_dim), (2, sb.sobol_sample_dim2)):
            start = min(dim, ROWS - k)
            want = plain(lo, hi, dim, scr, sm32).numpy().reshape(-1, k)
            got = _lane_model(lo.numpy(), hi.numpy(),
                              table[start:start + k], scr.numpy())
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
    for domain in DOMAINS:
        frame = int(rng.choice(FRAMES))
        b_base, words, inv = _index_inputs(domain, frame, seed)
        want = sb.sobol_index(b_base, *words, *inv)
        for g, w in zip(_index_model(b_base.numpy(), words, inv), want):
            np.testing.assert_array_equal(g, w.numpy())


# the host model of the kernels: a stand-in for the CUDA runtime, the
# source up to the end of its anonymous namespace, and one C function a
# launcher that runs its kernel's body for each lane
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
static inline float __uint2float_rn(uint32_t v) { return (float)v; }
"""
_LANE_LOOP = r"""
}  // namespace
// each block's threads twice: the first round stages its shared rows
#define LANES(call)                                            \
  for (int b = 0; b * kThreads < n; ++b)                      \
    for (int round = 0; round < 2; ++round)                   \
      for (int t = 0; t < kThreads; ++t) {                     \
        blockIdx.x = b;                                        \
        threadIdx.x = t;                                       \
        call;                                                  \
      }
extern "C" void host_sobol_index(const int64_t* b_base,
                                 const int64_t* inv_lo,
                                 const int64_t* inv_hi,
                                 const int64_t* w_delta, const int64_t* w_lo,
                                 const int64_t* w_hi, int delta, int lo,
                                 int hi, int n, int64_t* out_lo,
                                 int64_t* out_hi) {
  const FrameWords w = {{w_delta, w_lo, w_hi},
                        {(uint32_t)delta, (uint32_t)lo, (uint32_t)hi}};
  LANES(sobol_index_kernel(b_base, inv_lo, inv_hi, w, n, out_lo, out_hi));
}
extern "C" void host_sobol_draw(const int64_t* idx_lo, const int64_t* idx_hi,
                                const int64_t* scramble,
                                const int64_t* table, int dim, int k,
                                int rows, int n, float* out) {
  const int64_t* row = table + (size_t)first_row(dim, k, rows) * ROW_WORDS;
  if (k == 1) {
    LANES(sobol_draw_kernel<1>(idx_lo, idx_hi, scramble, row, n, out));
  } else {
    LANES(sobol_draw_kernel<2>(idx_lo, idx_hi, scramble, row, n, out));
  }
}
"""


@pytest.fixture(scope="module")
def host_model(tmp_path_factory):
    """csrc/sobol.cu compiled for the host with ``c++`` (its launchers
    left out: the rest is plain C++ under the shim)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("sobol_host")
    (tmp / "cuda_runtime.h").write_text(_SHIM)
    with open(os.path.join(_build.CSRC_DIR, sobol_cu.SOURCE)) as fh:
        src = fh.read()
    (tmp / "model.cpp").write_text(src[:src.index("}  // namespace")] +
                                   _LANE_LOOP)
    lib = tmp / "libsobol_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{tmp}", "-w", "-o", str(lib), str(tmp / "model.cpp")],
                   check=True, capture_output=True)
    model = ctypes.CDLL(str(lib))
    arg = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for kernel, sig in sobol_cu.SIGNATURES.items():
        getattr(model, f"host_{kernel}").argtypes = [arg[c]
                                                     for c in sig[:-1]]
    return model


def _ptr(x):
    return 0 if x is None else x.data_ptr()


@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["host_ints", "tensors"])
@pytest.mark.parametrize("domain", DOMAINS, ids=lambda d: f"{d[1][0]}px")
def test_index_source_on_the_host_matches_plain(host_model, domain,
                                                as_tensors):
    """The index kernel, run on the host a lane at a time, gives the plain
    ``sobol_index``'s words over the frames, the frame words as values and
    as pointers to 0-d int64 tensors."""
    for frame in FRAMES:
        b_base, words, inv = _index_inputs(domain, frame, frame, n=1031)
        want = sb.sobol_index(b_base, *words, *inv)
        tensors = [torch.tensor(w, dtype=torch.int64) for w in words]
        ptrs = [t.data_ptr() for t in tensors] if as_tensors else [0] * 3
        vals = [0] * 3 if as_tensors else [sobol_cu._word(w, 0)[1]
                                           for w in words]
        got = [torch.full((1031,), -1, dtype=torch.int64) for _ in range(2)]
        host_model.host_sobol_index(b_base.data_ptr(), inv[0].data_ptr(),
                                    inv[1].data_ptr(), *ptrs, *vals, 1031,
                                    got[0].data_ptr(), got[1].data_ptr())
        for g, w in zip(got, want):
            assert torch.equal(g, w), frame


@pytest.mark.parametrize("scrambled", [True, False],
                         ids=["scrambled", "unscrambled"])
@pytest.mark.parametrize("k", [1, 2])
def test_draw_source_on_the_host_matches_plain(host_model, k, scrambled):
    """The draw kernel, run on the host a lane at a time, gives the plain
    functions' bits at every dimension of the table and past it."""
    n = 517
    lo, hi, scr = _words(7, n), _words(8, n), _words(9, n)
    sm32 = sb.sm32_device("cpu")
    plain = sb.sobol_sample_dim if k == 1 else sb.sobol_sample_dim2
    for dim in _dims():
        want = plain(lo, hi, dim, scr if scrambled else torch.zeros_like(lo),
                     sm32)
        got = torch.full(want.shape, -1.0)
        host_model.host_sobol_draw(
            lo.data_ptr(), hi.data_ptr(), _ptr(scr if scrambled else None),
            sm32.data_ptr(), dim, k, ROWS, n, got.data_ptr())
        assert torch.equal(got, want), dim


@pytest.mark.parametrize("scene", ["cornell", "spheres"])
def test_band_frame_draws(monkeypatch, scene):
    """A band-frame of each benchmark configuration makes the draws of
    ``DRAWS`` through the wrapper (on the card, one K7 launch each), the
    camera pair unscrambled."""
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    path, depth = dict(cornell=(CORNELL, 5), spheres=(SPHERES, 15))[scene]
    cam, sd, _ = load_mitsuba(path, resolution=(12, 8), device="cpu")
    calls, unscrambled = collections.Counter(), []
    for name in ("sobol_index", "sobol_sample_dim", "sobol_sample_dim2"):
        def spy(*a, _real=getattr(sobol_cu, name), _name=name):
            calls[_name] += 1
            if _name != "sobol_index" and a[3] is None:
                unscrambled.append(a[2])
            return _real(*a)
        monkeypatch.setattr(sobol_cu, name, spy)
    before = dict(pint.GRAPH_COUNTS)
    PathIntegrator(PathConfig(max_depth=depth, mis_mode="onesample"),
                   spp=2).render(cam, TracedScene.create(sd))
    frames = pint.GRAPH_COUNTS["eager"] - before["eager"]
    assert frames == 2 and unscrambled == [0] * frames
    assert calls["sobol_index"] == DRAWS[scene]["sobol_index"] * frames
    assert calls["sobol_sample_dim"] + calls["sobol_sample_dim2"] == \
        DRAWS[scene]["sobol_draw"] * frames


@pytest.mark.parametrize("case", [
    dict(), dict(mis_mode="ref"), dict(light_strategy="all"),
    dict(max_depth=2), dict(max_depth=7, rr_enable=False),
    dict(sampler="stratified"), dict(scene="small_scene")],
    ids=["onesample", "ref", "all_lights", "depth2", "no_roulette",
         "stratified", "config_b"])
def test_chip_smoke_counts_a_renders_draws(monkeypatch, case):
    """``chip_smoke.sobol_launches``, which every main path's timed renders
    on the card hold K7's launches to, gives the wrapper calls a render
    makes: MIS modes, light strategies, depths, roulette on and off, a
    hash sampler (none) and a scene of other materials and lights."""
    import importlib.util

    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene import procedural
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    case = dict(case)
    name = case.pop("scene", None)
    if name is None:
        cam, sd, _ = load_mitsuba(os.path.join(ROOT, "data",
                                               "cornell-box.xml"),
                                  resolution=(12, 8), device="cpu")
    else:
        cam, sd = getattr(procedural, name)((12, 8), device="cpu")
    calls = collections.Counter()
    for fn in ("sobol_index", "sobol_sample_dim", "sobol_sample_dim2"):
        def spy(*a, _real=getattr(sobol_cu, fn), _fn=fn):
            calls["sobol_index" if _fn == "sobol_index"
                  else "sobol_draw"] += 1
            return _real(*a)
        monkeypatch.setattr(sobol_cu, fn, spy)
    cfg = dict(max_depth=5, mis_mode="onesample")
    integ = PathIntegrator(PathConfig(**{**cfg, **case}), spp=2)
    scene = TracedScene.create(sd)
    integ.render(cam, scene)
    want = smoke.sobol_launches(integ, cam, scene)
    assert dict(sobol_index=calls["sobol_index"],
                sobol_draw=calls["sobol_draw"]) == want
    assert (want["sobol_draw"] > 0) == (integ.cfg.sampler == "sobol")


# ---------------------------------------------------------------- card
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is a CUDA kernel with no "
                    "CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["host_ints", "tensors"])
@pytest.mark.parametrize("n", [1, 255, N, 130_732])
def test_index_matches_plain(dev, n, as_tensors):
    """K7's index ``torch.equal`` to the plain chain on the card, one
    launch a call: every domain, frames with the shifted high word set,
    random 32-bit frame words, the words as host ints and as 0-d device
    tensors."""
    cases = [(d, f) for d in DOMAINS for f in FRAMES]
    for domain, frame in cases + [(DOMAINS[3], None)]:
        b_base, words, inv = _index_inputs(domain, frame or 0, n % 97, n)
        if frame is None:  # random words, the top bit set
            words = tuple(int(w) | 1 << 31 for w in _words(n, 3))
        b_base, inv = b_base.to(dev), [x.to(dev) for x in inv]
        given = [torch.tensor(w, dtype=torch.int64, device=dev)
                 for w in words] if as_tensors else words
        before = sobol_cu.LAUNCHES["sobol_index"]
        got = sobol_cu.sobol_index(b_base, *given, *inv)
        assert sobol_cu.LAUNCHES["sobol_index"] == before + 1
        want = sb.sobol_index(b_base, *words, *inv)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and torch.equal(g, w), (domain,
                                                                  frame)


@pytest.mark.cuda
@pytest.mark.parametrize("scrambled", [True, False],
                         ids=["scrambled", "unscrambled"])
@pytest.mark.parametrize("k", [1, 2])
def test_draws_match_plain(dev, k, scrambled):
    """K7's draws ``torch.equal`` to the plain functions on the card, one
    launch a draw: every dimension of the table and past it, on a 640 x
    480 band's index at a frame with the shifted high word set, and on
    random index words."""
    b_base, words, inv = _index_inputs(DOMAINS[3], 4101, 3)
    lo, hi = sb.sobol_index(b_base.to(dev), *words, *(x.to(dev) for x in inv))
    sets = [(lo, hi), (_words(4, N).to(dev), _words(5, N).to(dev))]
    scr = _words(6, N).to(dev)
    sm32 = sb.sm32_device(dev)
    plain = sb.sobol_sample_dim if k == 1 else sb.sobol_sample_dim2
    wrapper = (sobol_cu.sobol_sample_dim if k == 1
               else sobol_cu.sobol_sample_dim2)
    zeros = torch.zeros_like(scr)
    for lo, hi in sets:
        before = sobol_cu.LAUNCHES["sobol_draw"]
        dims = _dims()
        for dim in dims:
            got = wrapper(lo, hi, dim, scr if scrambled else None, sm32)
            want = plain(lo, hi, dim, scr if scrambled else zeros, sm32)
            assert got.is_contiguous() and torch.equal(got, want), dim
        assert sobol_cu.LAUNCHES["sobol_draw"] == before + len(dims)


def _render(dev, scene, mode, monkeypatch):
    """Two 96 x 72 jobs at 8 spp in chunks of 4 of a benchmark
    configuration (cornell at depth 5, the spheres at 15), through one
    integrator: (films, band-frames, K7 launches). ``mode``: "graph"
    (replays), "eager" (the engagement test refuses), "plain" (eager,
    the draws through the plain chain)."""
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    path, depth = dict(cornell=(CORNELL, 5), spheres=(SPHERES, 15))[scene]
    cam, sd, _ = load_mitsuba(path, resolution=(96, 72), device=dev)
    integ = PathIntegrator(PathConfig(max_depth=depth, mis_mode="onesample"),
                           spp=8, band_rows=24)
    with monkeypatch.context() as mp:
        if mode != "graph":
            mp.setattr(pint, "_graph_engages", lambda scene, cfg: False)
        if mode == "plain":
            def unscrambled(plain):
                return lambda lo, hi, dim, scr, sm32: plain(
                    lo, hi, dim, torch.zeros_like(lo) if scr is None
                    else scr, sm32)
            mp.setattr(sobol_cu, "sobol_index", sb.sobol_index)
            mp.setattr(sobol_cu, "sobol_sample_dim",
                       unscrambled(sb.sobol_sample_dim))
            mp.setattr(sobol_cu, "sobol_sample_dim2",
                       unscrambled(sb.sobol_sample_dim2))
        scene_t = TracedScene.create(sd)
        before = dict(pint.GRAPH_COUNTS)
        launches = dict(sobol_cu.LAUNCHES)
        films = []
        for shift in (0.0, 0.05):
            c2w = cam.cam_to_world.copy()
            c2w[0, 3] += shift
            camera = dataclasses.replace(cam, cam_to_world=c2w)
            films.append(integ.render_progressive(camera, scene_t,
                                                  chunk_spp=4).cpu())
    frames = sum(v - before[k] for k, v in pint.GRAPH_COUNTS.items())
    return dict(films=films, frames=frames,
                launches={k: v - launches[k]
                          for k, v in sobol_cu.LAUNCHES.items()},
                replays=pint.GRAPH_COUNTS["replays"] - before["replays"])


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "spheres"])
def test_films_equal_across_paths_and_the_plain_chain(dev, scene,
                                                      monkeypatch):
    """On both benchmark configurations the films of graph replay, of the
    eager loop and of the eager loop with the plain chain's draws are
    ``torch.equal``; K7 launches ``DRAWS`` a band-frame on the two K7
    paths (a replay counts its capture's tally) and none on the plain
    one."""
    runs = {mode: _render(dev, scene, mode, monkeypatch)
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
            k: v * frames for k, v in DRAWS[scene].items()}, mode
    assert runs["plain"]["launches"] == dict(sobol_index=0, sobol_draw=0)
