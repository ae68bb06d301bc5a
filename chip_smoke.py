#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printing one JSON line:

1. device  - the card's name and power limit (also printed raw, as
             nvidia-smi gives them);
2. build   - compiles kernel K1 (csrc/intersect.cu), kernel K2
             (csrc/bvhw.cu) and the gather probes (csrc/gather_probe.cu,
             csrc/gather_probe2.cu) with nvcc, the launch module
             (csrc/pylaunch.c) with cc and the native BVH builder
             (csrc/bvh_builder.cpp) with g++, all at once;
3. k1      - K1 against its plain PyTorch version on the card, at the main
             path's shapes (131,072 rays x cornell's 36 triangles): hit
             flags, triangle ids and any-hit identical, t and b to
             rtol 1e-6 / atol 1e-7; both timed (below);
4. golden  - cornell 32x32, 2 spp, depth 3 ("ref" MIS) against
             tests/golden_cornell_32.npz (the JAX film) at RMSE < 1e-3 and
             alpha rtol 1e-5, with the exact K1 launch count; then the
             same scene through the BVH route (``use_bvh=True``: K2, no
             K1) against that K1 film at the same bar, both launch counts
             printed;
5. main    - cornell 640x480, 16 spp, depth 5, "onesample" MIS: one
             warm-up render, then three timed renders (Mrays/s: their
             median, min and max), each with the exact K1 launch count;
             finite film with positive weight everywhere;
6. k2      - K2 against its plain version on the full box-field table
             (4,000 boxes, 48,012 triangles) and 131,072 rays (camera rays
             of the first 1920x1080 band and random directions from inside
             the room): closest and any-hit, both timed; and against K1
             (brute force) on the same rays; the plain traversal counts
             the work these rays need (occupied children slab-tested, real
             triangles tested), for K2's bound (plain: 5 calls timed);
             then the same checks and times on a second ray set, "bounce":
             origins at the closest hits of 131,072 camera rays drawn over
             the whole image, backed off 1e-3 along -d, random unit
             directions (numpy seed 1), the camera rays' misses left in as
             dead lanes (t_max = 0); for both sets the interior and leaf
             rows visited and the bytes of them the kernel reads;
7. box_golden - box field 64x36, 2 spp, depth 3, "ref" MIS on the card
             against the port's own CPU film (the plain traversal) at
             RMSE < 1e-3 and alpha rtol 1e-5, exact K2 launch count, no K1;
8. box_main - box field 1920x1080, 4,000 boxes, 2 spp, depth 5,
             "onesample" MIS: one warm-up render, three timed renders
             (as phase 5), set-up seconds, table size, peak device
             memory, exact K2 launch count and no K1 in each, finite film
             with positive weight everywhere;
9. probes  - the gather probes P1-P5 once through ``run_probes`` (their
             path), then each against its plain version and its library
             call (one PyTorch call on the same int32 indices:
             ``table[idx]``, ``table_t[:, idx]``), exact, all timed;
10. probes2 - the gather probes P6-P9 likewise (library: ``torch.gather``;
             P9 ``tbl[idx]``, and ``torch.matmul`` of the one-hot
             operands beside it); then P9 against its plain version on a
             table of -0, +inf, -inf, NaN and all-negative columns, at
             S = 64, 1, 3 and 65 index rows (NaN in the same places, equal
             values and sign bits elsewhere);
11. materials_golden - configs B, C and D at 64x64, band_rows 16, 2 spp,
             depths 4, 6 and 4 ("ref" MIS) on the card, against the
             committed goldens at tests/test_golden.py's _golden_check bar
             (alpha rtol 1e-5, RMSE < 2e-3, mean within 2 %) and against
             the port's own CPU film (RMSE < 1e-3), exact K2 launch
             counts, no K1;
12. materials_main - each config at 640x480, 4 spp, "onesample" MIS
             (C at depth 15, B and D at depth 5): a 1 spp warm-up render,
             then three timed renders (as phase 5), each with the launch
             counts set to 0 just before it and checked after it (exact
             K2 count, no K1): set-up seconds, peak device memory, finite
             film with positive weight everywhere; then K2 against its
             plain version on the
             config's own table, on 131,072 camera rays drawn over the
             whole image (valid, tri, t and b identical, closest and any
             hit);
13. profile - device times from a torch.profiler trace: K1's and K2's
             (both ray sets, closest and any hit), P1-P9's and their library
             calls'; then one box-field render (as phase 8) under the
             profiler: its device time, K2's share of it and the launches
             (last, as tracing slows later launches).

"Timed" is three figures on CUDA events and the host clock: ``ms``, per
call over 100 back-to-back calls (the median of 5 such runs);
``ms_single``, the median of 30 single calls (the figure of earlier
runs); and, for a kernel wrapper, ``host_us``, the host's enqueue time per
call over 10,000 calls.

Then the script's total seconds (one JSON line), one JSON line listing
the kernels, each with those times, its device
time, its plain version's and its library call's times where one exists
(with the library call's device time), and its bound (the least time an
H100 could take: the larger of the bytes it must move over 3.35 TB/s and
the FP32 operations it needs on this run's inputs over 67 TFLOP/s), and
last the status line. Any failure raises (non-zero exit). Without a CUDA
card it exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")
GOLDEN = os.path.join(ROOT, "tests", "golden_cornell_32.npz")
K1_RAYS = 1 << 17
K1_REPS = 30
# back-to-back calls of a per-call time, and the runs of them it is the
# median of; calls of a host enqueue time, synchronised every HOST_CHUNK
# calls (outside the clock)
PER_CALL = 100
PER_CALL_RUNS = 5
HOST_CALLS = 10_000
HOST_CHUNK = 100
K2_RAYS = 1 << 17
# the plain traversal runs a Python loop of ~100 tensor ops per step
PLAIN_K2_REPS = 5
BOX_RES = (1920, 1080)
BOX_BOXES = 4000
# configs B, C, D: (builder, golden, golden depth, main depth)
MATERIAL_CONFIGS = {
    "B": ("small_scene", "golden_small_64.npz", 4, 5),
    "C": ("microfacet_scene", "golden_microfacet_64.npz", 6, 15),
    "D": ("envmap_disney_scene", "golden_envmap_64.npz", 4, 5),
}
MAT_RES = (640, 480)
MAT_SPP = 4
# timed renders of each main path after its warm-up; the figure is their
# median (single renders of one tree have spread by up to 1.8x on a
# shared host)
RENDER_REPS = 3

# the H100 SXM's published peaks (NVIDIA data sheet; 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations every ray-triangle pair pays in the watertight test
# before its early exit: 9 translations, 6 shear multiply-adds (12) and
# 3 edge functions of two products and a difference (9)
PAIR_OPS = 30
# per occupied child slab test of a BVH32 interior row: per axis 2
# subtractions, 2 multiplies, a min, a max and the gamma scaling (21), the
# entry / exit reduction (4) and the two range compares (2)
SLAB_OPS = 27


def bound(nbytes: float, ops: float) -> dict:
    """The least time an H100 could take for work that must move
    ``nbytes`` and do ``ops`` FP32 operations, and which of the two sets
    it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = K1_REPS) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def per_call_ms(fn, calls: int = PER_CALL,
                runs: int = PER_CALL_RUNS) -> float:
    """Milliseconds per call of ``fn``: a pair of CUDA events around
    ``calls`` back-to-back calls, divided by ``calls``, the median of
    ``runs`` such runs after one warm-up call. The device's time where the
    host enqueues faster than the device runs, the host's where it does
    not; the median drops a run that a host stall lengthened."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def host_us(fn, calls: int = HOST_CALLS, chunk: int = HOST_CHUNK) -> float:
    """Microseconds of host time per call of ``fn``: a host clock over
    ``calls`` calls with no synchronise inside the clocked spans. The
    calls run in spans of ``chunk``, synchronised between spans outside
    the clock, so that a kernel slower than its enqueue never fills the
    launch queue and makes the host wait for the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // chunk):
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls // chunk * chunk) * 1e6


def timed_renders(integ, cam, scene, expect: dict, what: str) -> dict:
    """RENDER_REPS timed renders of a main path (after the caller's
    warm-up), each with every kernel count of ``expect`` ({wrapper module:
    launches}) set to 0 just before it and checked just after it. Returns
    the last film and the renders' figures: Mrays/s as the median, min and
    max of the renders, with each render's seconds."""
    import torch
    seconds = []
    for _ in range(RENDER_REPS):
        for mod in expect:
            mod.LAUNCHES = 0  # the main path's run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = integ.render(cam, scene)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        got = {mod.__name__.rsplit(".", 1)[-1]: mod.LAUNCHES for mod in expect}
        want = {mod.__name__.rsplit(".", 1)[-1]: n
                for mod, n in expect.items()}
        if got != want:
            raise AssertionError(f"{what} render launched {got}, expected "
                                 f"{want}")
    rates = [integ.last_ray_count / dt / 1e6 for dt in seconds]
    return film, dict(rays=integ.last_ray_count,
                      seconds=statistics.median(seconds),
                      seconds_runs=seconds,
                      mrays_per_s=statistics.median(rates),
                      mrays_per_s_min=min(rates), mrays_per_s_max=max(rates),
                      renders=RENDER_REPS)


def timings(kernel, plain=None, library=None, plain_calls: int = PER_CALL,
            plain_reps: int = K1_REPS) -> dict:
    """A kernel wrapper's times beside its plain version's and its library
    call's: ``ms`` per call over PER_CALL back-to-back calls (the median
    of PER_CALL_RUNS runs), ``ms_single`` the median of K1_REPS single
    calls (the figure of earlier runs), the wrapper's ``host_us``;
    ``plain_ms`` / ``library_ms`` likewise (None where there is none)."""
    out = dict(ms=per_call_ms(kernel), ms_single=time_ms(kernel),
               host_us=host_us(kernel), plain_ms=None, plain_ms_single=None,
               library_ms=None, library_ms_single=None)
    if plain is not None:
        out.update(plain_ms=per_call_ms(plain, plain_calls),
                   plain_ms_single=time_ms(plain, plain_reps))
    if library is not None:
        out.update(library_ms=per_call_ms(library),
                   library_ms_single=time_ms(library))
    return out


def kernel_device_ms(fn, name: str | None = None,
                     reps: int = K1_REPS) -> float:
    """Mean device time (ms) per call of ``fn`` from torch.profiler's
    CUPTI trace: of the CUDA kernels whose name contains ``name``, or of
    all its device work with no name. The kernel alone, without the
    host's per-call dispatch gaps that CUDA events around a call count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if name is None or name in e.key)
    if us <= 0:
        raise AssertionError(f"profiler saw no device time for {name}")
    return us / reps / 1e3


def first_band_rays(cam, integ, dev):
    """The camera rays of the first row band of a render (sample frame 0)
    and the band's Sobol indices and scrambles. Returns (o, d, idx_lo,
    idx_hi, scramble) on ``dev``."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.core.camera import generate_rays
    from pathtracer_tpu_torch.core.film import sample_bounds
    from pathtracer_tpu_torch.core.math import ONE_MINUS_EPSILON
    from pathtracer_tpu_torch.ops import sobol as sb

    band, _ = integ.band_layout(cam)
    (x0, y0), (x1, y1) = sample_bounds(*cam.resolution, integ.filter_radius)
    domain = sb.SobolDomain.create((x0, y0), (x1, y1), integ.spp)
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y0 + band),
                         indexing="xy")
    px, py = xs.ravel(), ys.ravel()
    scramble, b_base = sb.pixel_statics(domain, px, np.minimum(py, y1 - 1))
    lo, hi, delta = sb.frame_statics(domain, 0)
    idx_lo, idx_hi = sb.sobol_index(
        torch.as_tensor(b_base.astype(np.int64), device=dev), int(delta),
        int(lo), int(hi), *sb.vdc_inv_rows(domain, dev))
    s01 = sb.sobol_sample_dim2(idx_lo, idx_hi, 0,
                               torch.zeros_like(idx_lo), sb.sm32_device(dev))
    pxf = torch.as_tensor(px, dtype=torch.float32, device=dev)
    pyf = torch.as_tensor(py, dtype=torch.float32, device=dev)
    one_minus = float(ONE_MINUS_EPSILON)
    jx = torch.clamp(s01[:, 0] * float(domain.resolution) + x0 - pxf,
                     0.0, one_minus)
    jy = torch.clamp(s01[:, 1] * float(domain.resolution) + y0 - pyf,
                     0.0, one_minus)
    o, d = generate_rays(*cam.ray_params(dev),
                         torch.stack([pxf + jx, pyf + jy], dim=-1))
    scr = torch.as_tensor(scramble.astype(np.int64), device=dev)
    return o.expand(d.shape[0], 3), d, idx_lo, idx_hi, scr


def k1_inputs(dev, n_rays: int = K1_RAYS, resolution=(640, 480)):
    """The main path's K1 inputs: the camera rays of the first row band
    of a cornell render (sample frame 0), and shadow rays spawned from
    their hits toward the area light, mixed at random (seed 0) to
    ``n_rays`` rays. Returns (scene, o, d, t_max)."""
    import torch

    from pathtracer_tpu_torch.integrator import (PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.ops import interaction as ia
    from pathtracer_tpu_torch.ops import lights as lt
    from pathtracer_tpu_torch.ops import sobol as sb
    from pathtracer_tpu_torch.ops.cuda.intersect_cu import intersect_plain
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(CORNELL, resolution=resolution, device=dev)
    scene = TracedScene.create(sd)
    o, d, idx_lo, idx_hi, scr = first_band_rays(
        cam, PathIntegrator(spp=16), dev)
    n_cam = o.shape[0]
    t_inf = torch.full((n_cam,), torch.inf, device=dev)

    # shadow rays toward the light, spawned off the camera rays' hits
    hit = intersect_plain(o.contiguous(), d.contiguous(), t_inf,
                          scene.tri_pack)
    it = ia.make_interaction(sd, o, d, hit, scene.tri_attr)
    sm32 = sb.sm32_device(dev)
    u = sb.sobol_sample_dim2(idx_lo, idx_hi, 2, scr, sm32)
    pick = torch.clamp_max(
        (sb.sobol_sample_dim(idx_lo, idx_hi, 6, scr, sm32)
         * scene.n_lights).to(torch.int64), scene.n_lights - 1)
    ls = lt.sample_li(sd, scene.light_attr[pick], it["p"], it["p_error"],
                      it["ng"], u)
    so, sdir, st = ia.spawn_ray_to(it["p"], it["p_error"], it["ng"],
                                   ls["target_p"], ls["target_err"],
                                   ls["target_n"])
    gen = torch.Generator().manual_seed(0)
    pick_rays = torch.randperm(2 * n_cam, generator=gen)[:n_rays].to(dev)
    o_all = torch.cat([o, so])[pick_rays].contiguous()
    d_all = torch.cat([d, sdir])[pick_rays].contiguous()
    t_all = torch.cat([t_inf, st])[pick_rays].contiguous()
    return scene, o_all, d_all, t_all


def phase_k1(dev):
    import torch

    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    scene, o, d, t_max = k1_inputs(dev)
    n, f = o.shape[0], scene.tri_pack.shape[0]
    got = k1.intersect(o, d, t_max, scene.tri_pack)
    want = k1.intersect_plain(o, d, t_max, scene.tri_pack)
    got_any = k1.intersect(o, d, t_max, scene.tri_pack, any_hit=True)
    want_any = k1.intersect_plain(o, d, t_max, scene.tri_pack, any_hit=True)
    torch.cuda.synchronize()
    if not torch.equal(got["valid"], want["valid"]):
        raise AssertionError("K1 valid differs from the plain version")
    if not torch.equal(got["tri"], want["tri"]):
        raise AssertionError("K1 tri differs from the plain version")
    if not torch.equal(got_any, want_any):
        raise AssertionError("K1 any-hit differs from the plain version")
    hit = want["valid"]
    if int(hit.sum()) == 0 or bool(hit.all()):
        raise AssertionError("K1 inputs need both hits and misses")
    errs = {}
    for key in ("t", "b"):
        a, b = got[key], want[key]
        torch.testing.assert_close(a[hit], b[hit], rtol=1e-6, atol=1e-7)
        if not bool((a[~hit] == 0).all()):
            raise AssertionError(f"K1 {key} must be 0 on misses")
        errs[key] = float((a[hit] - b[hit]).abs().max())
    t_bits_equal = float((got["t"] == want["t"]).float().mean())

    times = timings(lambda: k1.intersect(o, d, t_max, scene.tri_pack),
                    lambda: k1.intersect_plain(o, d, t_max, scene.tri_pack))
    ms_any = time_ms(lambda: k1.intersect(o, d, t_max, scene.tri_pack,
                                          any_hit=True))
    plain_ms_any = time_ms(lambda: k1.intersect_plain(
        o, d, t_max, scene.tri_pack, any_hit=True))
    # inputs o, d, t_max (28 B a ray) and the (F, 12) table; outputs
    # valid, t, tri and b (21 B a ray)
    out = dict(phase="k1", rays=n, triangles=f, hit_lanes=int(hit.sum()),
               **bound(49.0 * n + 48.0 * f, PAIR_OPS * float(n) * f),
               anyhit_lanes=int(want_any.sum()), max_abs_err_t=errs["t"],
               max_abs_err_b=errs["b"], t_bit_equal_frac=t_bits_equal,
               **times, ms_anyhit=ms_any, plain_ms_anyhit=plain_ms_any,
               reps=K1_REPS, per_call=PER_CALL,
               mrays_per_s=n / times["ms"] / 1e3)
    emit(out)
    return out


def phase_golden(dev):
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(CORNELL, resolution=(32, 32), device=dev)
    cfg = PathConfig(max_depth=3)
    integ = PathIntegrator(cfg, spp=2)
    before = k1.LAUNCHES
    film = integ.render(cam, sd)
    torch.cuda.synchronize()
    launches = k1.LAUNCHES - before
    _, n_bands = integ.band_layout(cam)
    expect = n_bands * integ.spp * (3 * cfg.max_depth + 1)
    if launches != expect:
        raise AssertionError(f"golden render launched K1 {launches} times, "
                             f"expected {expect}")
    got = film.cpu().numpy()
    want = np.load(GOLDEN)["film"]
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = float(np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2)))
    if not rmse < 1e-3:
        raise AssertionError(f"golden RMSE {rmse} >= 1e-3")
    # the same scene through K2: the BVH route forced on cornell's 36
    # triangles, against the K1 film just rendered
    bvh_scene = TracedScene.create(sd, use_bvh=True)
    k1_before, k2_before = k1.LAUNCHES, k2.LAUNCHES
    bvh_film = integ.render(cam, bvh_scene)
    torch.cuda.synchronize()
    bvh_launches = (k1.LAUNCHES - k1_before, k2.LAUNCHES - k2_before)
    if bvh_launches != (0, expect):
        raise AssertionError(f"cornell through the BVH route launched (K1, "
                             f"K2) {bvh_launches} times, expected "
                             f"{(0, expect)}")
    bvh_got = bvh_film.cpu().numpy()
    np.testing.assert_allclose(bvh_got[..., 3], got[..., 3], rtol=1e-5)
    rmse_k1_k2 = float(np.sqrt(np.mean((bvh_got[..., :3]
                                        - got[..., :3]) ** 2)))
    if not rmse_k1_k2 < 1e-3:
        raise AssertionError(f"cornell K1 and K2 films differ: RMSE "
                             f"{rmse_k1_k2} >= 1e-3")
    out = dict(phase="golden", rmse=rmse,
               alpha_max_rel=float(np.max(np.abs(got[..., 3] - want[..., 3])
                                          / np.abs(want[..., 3]))),
               launches=launches, expected_launches=expect,
               k2_route=dict(k1_launches=launches, k2_launches=bvh_launches[1],
                             table_rows=int(bvh_scene.bw_rows.shape[0]),
                             rmse_k1_vs_k2=rmse_k1_k2,
                             rmse_k2_vs_golden=float(np.sqrt(np.mean(
                                 (bvh_got[..., :3] - want[..., :3]) ** 2)))))
    emit(out)
    return out


def phase_main(dev, smi: str):
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(CORNELL, resolution=(640, 480), device=dev)
    scene = TracedScene.create(sd)
    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    integ = PathIntegrator(cfg, spp=16)
    _, n_bands = integ.band_layout(cam)
    expect = n_bands * integ.spp * (2 * cfg.max_depth + 1)

    before = k1.LAUNCHES
    t0 = time.perf_counter()
    integ.render(cam, scene)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if k1.LAUNCHES - before != expect:
        raise AssertionError(f"warm-up render launched K1 "
                             f"{k1.LAUNCHES - before} times, expected "
                             f"{expect}")

    film, runs = timed_renders(integ, cam, scene, {k1: expect}, "main")
    launches = k1.LAUNCHES
    if tuple(film.shape) != (480, 640, 4):
        raise AssertionError(f"film shape {tuple(film.shape)}")
    if not bool(torch.isfinite(film).all()):
        raise AssertionError("film has non-finite values")
    if not bool((film[..., 3] > 0).all()):
        raise AssertionError("film weight must be positive everywhere")
    out = dict(phase="main", resolution=[640, 480], spp=integ.spp,
               max_depth=cfg.max_depth, mis_mode=cfg.mis_mode,
               bands=n_bands, **runs, warmup_seconds=warm_s,
               launches=launches, expected_launches=expect,
               bad_samples=integ.bad_sample_count,
               film_mean_rgb=[float(v) for v in
                              film[..., :3].mean(dim=(0, 1)).cpu()],
               card=smi)
    emit(out)
    return out


def box_scene(dev, resolution=BOX_RES, n_boxes: int = BOX_BOXES):
    """The box field on ``dev`` and its TracedScene. Returns (camera,
    scene, seconds of TracedScene.create: BVH build, reorder and upload)."""
    import torch

    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.scene.procedural import box_field_scene

    cam, sd = box_field_scene(resolution, n_boxes=n_boxes, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = TracedScene.create(sd)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return cam, scene, time.perf_counter() - t0


def k2_inputs(dev, n_rays: int = K2_RAYS):
    """K2's inputs on the full box field: the first n_rays / 2 camera rays
    of the first 1920x1080 band, and n_rays / 2 random directions from a
    point inside the room above the boxes (numpy seed 0). Returns (scene,
    o, d, t_inf, t_any), t_any a random finite bound in [0.5, 40) for the
    any-hit query."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator

    cam, scene, _ = box_scene(dev)
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=2)
    o_cam, d_cam = first_band_rays(cam, integ, dev)[:2]
    half = n_rays // 2
    if o_cam.shape[0] < half:
        raise AssertionError(f"first band has {o_cam.shape[0]} rays, "
                             f"fewer than {half}")
    rng = np.random.default_rng(0)
    d_rnd = rng.normal(size=(n_rays - half, 3)).astype(np.float32)
    d_rnd /= np.linalg.norm(d_rnd, axis=-1, keepdims=True)
    o_rnd = np.tile(np.float32([0.0, 12.0, 0.0]), (n_rays - half, 1))

    def t(a):
        return torch.as_tensor(a, device=dev)
    o = torch.cat([o_cam[:half], t(o_rnd)]).contiguous()
    d = torch.cat([d_cam[:half], t(d_rnd)]).contiguous()
    t_inf = torch.full((n_rays,), torch.inf, device=dev)
    t_any = t(rng.uniform(0.5, 40.0, n_rays).astype(np.float32))
    return scene, o, d, t_inf, t_any


def k2_bounce_inputs(dev, n_rays: int = K2_RAYS):
    """K2's second ray set on the full box field, the rays of a later
    bounce: ``n_rays`` camera rays drawn over the whole 1920x1080 image
    (sample frame 0, torch seed 0) are traced to their closest hits (the
    plain traversal); the set's origins are those hits backed off 1e-3
    along -d, its directions random unit vectors (numpy seed 1), and the
    camera rays that missed stay in as dead lanes (t_max = 0). Returns
    (scene, o, d, t_max, t_any), t_any a random bound in [0.5, 40) on the
    live lanes for the any-hit query."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.accel.bvhw import bvhw_intersect as bvhw_plain
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator

    cam, scene, _ = box_scene(dev)
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=2, band_rows=1 << 20)  # one band
    o_cam, d_cam = first_band_rays(cam, integ, dev)[:2]
    gen = torch.Generator().manual_seed(0)
    pick = torch.randperm(d_cam.shape[0], generator=gen)[:n_rays].to(dev)
    o_cam, d_cam = o_cam[pick].contiguous(), d_cam[pick].contiguous()
    hit = bvhw_plain(scene.bw_rows, o_cam, d_cam,
                     torch.full((n_rays,), torch.inf, device=dev),
                     stackw=scene.bw_depth)
    rng = np.random.default_rng(1)
    d_rnd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d_rnd /= np.linalg.norm(d_rnd, axis=-1, keepdims=True)
    live = hit["valid"]
    o = (o_cam + d_cam * hit["t"][:, None] - 1e-3 * d_cam).contiguous()
    d = torch.as_tensor(d_rnd, device=dev)
    t_any = torch.as_tensor(rng.uniform(0.5, 40.0, n_rays).astype(np.float32),
                            device=dev)
    zero = torch.zeros((), device=dev)
    return (scene, o, d, torch.where(live, torch.inf, zero),
            torch.where(live, t_any, zero))


# bytes of a row the kernel reads on a visit: six 128-byte lines of slab
# words and the sectors of the header and the kind word of an interior row;
# every sector of a leaf row
INTERIOR_ROW_BYTES = 6 * 128 + 2 * 32
LEAF_ROW_BYTES = 1024


def k2_ray_set(name, scene, o, d, t_max, t_any, check_k1: bool):
    """K2 against its plain version on one ray set of the box field,
    closest hit (bound ``t_max``) and any hit (bound ``t_any``), and its
    times. The plain traversal counts the work these rays need."""
    import torch

    from pathtracer_tpu_torch.accel.bvhw import bvhw_intersect as bvhw_plain
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    table, stackw = scene.bw_rows, scene.bw_depth

    def kernel(bound, any_hit=False):
        return k2.bvhw_intersect(table, o, d, bound, any_hit=any_hit,
                                 stackw=stackw)

    def plain(bound, any_hit=False, row_counts=None):
        return bvhw_plain(table, o, d, bound, any_hit=any_hit, stackw=stackw,
                          row_counts=row_counts)

    got, got_any = kernel(t_max), kernel(t_any, True)
    rows, rows_any = {}, {}
    want = plain(t_max, row_counts=rows)
    want_any = plain(t_any, True, row_counts=rows_any)
    torch.cuda.synchronize()
    for key in ("valid", "tri", "t", "b"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"K2 {key} differs from the plain version "
                                 f"({name} rays)")
    if not torch.equal(got_any, want_any):
        raise AssertionError(f"K2 any-hit differs from the plain version "
                             f"({name} rays)")
    hit = want["valid"]
    if int(hit.sum()) == 0 or bool(hit.all()) or bool(want_any.all()) \
            or not bool(want_any.any()):
        raise AssertionError(f"K2 inputs need both hits and misses ({name})")
    errs = {key: float((got[key] - want[key]).abs().max())
            for key in ("t", "b")}
    out = {}
    if check_k1:
        # against brute force (K1, no triangle cap) on the same rays
        brute = k1.intersect(o, d, t_max, scene.tri_pack)
        brute_any = k1.intersect(o, d, t_any, scene.tri_pack, any_hit=True)
        torch.cuda.synchronize()
        if not torch.equal(got["valid"], brute["valid"]):
            raise AssertionError("K2 valid differs from brute force (K1)")
        if not torch.equal(got_any, brute_any):
            raise AssertionError("K2 any-hit differs from brute force (K1)")
        torch.testing.assert_close(got["t"][hit], brute["t"][hit], rtol=1e-5,
                                   atol=0.0)
        tri_differ = hit & (got["tri"] != brute["tri"])
        if not torch.equal(got["t"][tri_differ], brute["t"][tri_differ]):
            raise AssertionError("K2 and K1 pick different triangles at "
                                 "different t")
        out.update(k1_tri_ties=int(tri_differ.sum()),
                   k1_max_rel_err_t=float(
                       ((got["t"][hit] - brute["t"][hit]).abs()
                        / brute["t"][hit]).max()))

    times = timings(lambda: kernel(t_max), lambda: plain(t_max),
                    plain_calls=PLAIN_K2_REPS, plain_reps=PLAIN_K2_REPS)
    ms_any = time_ms(lambda: kernel(t_any, True))
    plain_ms_any = time_ms(lambda: plain(t_any, True), reps=PLAIN_K2_REPS)
    n = o.shape[0]
    for r in (rows, rows_any):
        r["row_bytes_read"] = (INTERIOR_ROW_BYTES * r["interior"]
                               + LEAF_ROW_BYTES * r["leaf"])
    # rays in and out (49 B a ray) and the table; the closest-hit query's
    # work: a slab test per occupied child of each interior row visited, a
    # pair test per real triangle of each leaf row visited
    out.update(rays=n, live_lanes=int((t_max > 0).sum()), rows_visited=rows,
               rows_visited_anyhit=rows_any,
               **bound(49.0 * n + table.numel() * 4.0,
                       SLAB_OPS * float(rows["slabs"])
                       + PAIR_OPS * float(rows["triangles"])),
               hit_lanes=int(hit.sum()), anyhit_lanes=int(want_any.sum()),
               max_abs_err_t=errs["t"], max_abs_err_b=errs["b"],
               t_bit_equal_frac=float((got["t"] == want["t"]).float().mean()),
               **times, ms_anyhit=ms_any, plain_ms_anyhit=plain_ms_any,
               mrays_per_s=n / times["ms"] / 1e3)
    return out


def phase_k2(dev):
    scene, o, d, t_inf, t_any = k2_inputs(dev)
    first = k2_ray_set("camera and room", scene, o, d, t_inf, t_any,
                       check_k1=True)
    bounce = k2_ray_set("bounce", *k2_bounce_inputs(dev), check_k1=False)
    table = scene.bw_rows
    out = dict(phase="k2", **first, bounce=bounce,
               triangles=int(scene.tri_pack.shape[0]),
               table_rows=int(table.shape[0]), depth=scene.bw_depth,
               reps=K1_REPS, per_call=PER_CALL, plain_reps=PLAIN_K2_REPS)
    emit(out)
    return out


def phase_box_golden(dev):
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    cfg = PathConfig(max_depth=3)
    films = {}
    for where in ("cpu", "cuda"):
        cam, scene, _ = box_scene(torch.device(where) if where == "cpu"
                                  else dev, resolution=(64, 36))
        integ = PathIntegrator(cfg, spp=2)
        k1_before, k2_before = k1.LAUNCHES, k2.LAUNCHES
        film = integ.render(cam, scene)
        if where == "cuda":
            torch.cuda.synchronize()
        _, n_bands = integ.band_layout(cam)
        launches = (k1.LAUNCHES - k1_before, k2.LAUNCHES - k2_before)
        expect = (0, 0) if where == "cpu" else \
            (0, n_bands * integ.spp * (3 * cfg.max_depth + 1))
        if launches != expect:
            raise AssertionError(f"box golden on {where} launched (K1, K2) "
                                 f"{launches} times, expected {expect}")
        films[where] = (film.cpu().numpy(), launches[1], integ.last_ray_count)
    got, want = films["cuda"][0], films["cpu"][0]
    if not (np.isfinite(got).all() and (got[..., 3] > 0).all()):
        raise AssertionError("box golden film must be finite with "
                             "positive weight")
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = float(np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2)))
    if not rmse < 1e-3:
        raise AssertionError(f"box golden RMSE {rmse} >= 1e-3")
    diff = np.abs(got[..., :3] - want[..., :3]).max(axis=-1)
    out = dict(phase="box_golden", rmse=rmse,
               alpha_max_rel=float(np.max(np.abs(got[..., 3] - want[..., 3])
                                          / np.abs(want[..., 3]))),
               pixels_differing=int((diff > 0).sum()),
               max_pixel_diff=float(diff.max()), launches=films["cuda"][1],
               rays_card=films["cuda"][2], rays_cpu=films["cpu"][2])
    emit(out)
    return out


def phase_box_main(dev, smi: str):
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    torch.cuda.reset_peak_memory_stats(dev)
    cam, scene, create_s = box_scene(dev)
    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    integ = PathIntegrator(cfg, spp=2)
    _, n_bands = integ.band_layout(cam)
    expect = n_bands * integ.spp * (2 * cfg.max_depth + 1)

    t0 = time.perf_counter()
    integ.render(cam, scene)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    film, runs = timed_renders(integ, cam, scene, {k2: expect, k1: 0},
                               "box field")
    launches, k1_launches = k2.LAUNCHES, k1.LAUNCHES
    w, h = BOX_RES
    if tuple(film.shape) != (h, w, 4):
        raise AssertionError(f"film shape {tuple(film.shape)}")
    if not bool(torch.isfinite(film).all()):
        raise AssertionError("film has non-finite values")
    if not bool((film[..., 3] > 0).all()):
        raise AssertionError("film weight must be positive everywhere")
    table = scene.bw_rows
    out = dict(phase="box_main", resolution=list(BOX_RES),
               n_boxes=BOX_BOXES, triangles=int(scene.tri_pack.shape[0]),
               table_rows=int(table.shape[0]),
               table_bytes=table.numel() * table.element_size(),
               depth=scene.bw_depth, spp=integ.spp,
               max_depth=cfg.max_depth, mis_mode=cfg.mis_mode,
               bands=n_bands, **runs, warmup_seconds=warm_s,
               create_seconds=create_s, launches=launches,
               expected_launches=expect,
               k1_launches=k1_launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               bad_samples=integ.bad_sample_count,
               film_mean_rgb=[float(v) for v in
                              film[..., :3].mean(dim=(0, 1)).cpu()],
               card=smi)
    emit(out)
    return out


def probe_library(x) -> dict:
    """One PyTorch call computing each of P1-P5's functions on the probe's
    own int32 indices (P5 has none)."""
    def rows():
        return x["table"][x["idx"]]
    return dict(P1=rows, P2=rows, P3=lambda: x["table_t"][:, x["idx"]],
                P4=rows, P5=None)


def probe2_library(x) -> dict:
    """As ``probe_library`` for P6-P9 (P8 has none). P9's is ``tbl[idx]``
    (its function on finite tables); "P9 matmul" is the one-hot product
    ``torch.matmul`` on the one-hot operand, made here."""
    import torch
    import torch.nn.functional as F
    tbl, idx = x["tbl_j"], x["idx_j"]
    onehot = F.one_hot(idx.long().reshape(-1), tbl.shape[1]).float()
    return {"P6": lambda: torch.gather(x["data_g"], 0, x["idx_g"]),
            "P7": lambda: torch.gather(x["data_h"], 1, x["idx_h"]),
            "P8": None, "P9": lambda: tbl[idx],
            "P9 matmul": lambda: torch.matmul(onehot, tbl)}


def phase_probes(dev):
    import torch

    from pathtracer_tpu_torch.probes import gather as pg

    x = pg.probe_inputs(dev)
    for key in pg.LAUNCHES:  # the probes' path starts here
        pg.LAUNCHES[key] = 0
    outs = pg.run_probes(dev, x)
    torch.cuda.synchronize()
    launches = dict(pg.LAUNCHES)
    if launches != {"gather_rows": 2, "gather_cols": 1,
                    "gather_rows_warp": 1, "stack_push_read": 1}:
        raise AssertionError(f"probe launches {launches}")
    # the bytes each probe must move: its indices, the distinct table rows
    # they name, its output; P5 its pointers, values and output
    rows = torch.unique(x["idx"]).numel()
    gather = bound(4.0 * pg.N + 4.0 * pg.W * (rows + pg.N), 0.0)
    bounds = dict(P1=gather, P2=gather, P3=gather, P4=gather,
                  P5=bound(12.0 * pg.N, 0.0))
    library = probe_library(x)
    probes = {}
    for pid, fn in pg.PROBES.items():
        want = pg.PLAIN[pid](x)
        if not torch.equal(outs[pid], want):
            raise AssertionError(f"{pid} differs from its plain version")
        if library[pid] is not None and not torch.equal(library[pid](),
                                                        want):
            raise AssertionError(f"{pid}'s library call differs")
        probes[pid] = dict(**timings(lambda: fn(x), lambda: pg.PLAIN[pid](x),
                                     library[pid]), **bounds[pid])
    out = dict(phase="probes", M=pg.M, W=pg.W, N=pg.N, D=pg.D,
               launches=launches, reps=K1_REPS, per_call=PER_CALL,
               probes=probes)
    emit(out)
    return out


def phase_probes2(dev):
    import torch

    from pathtracer_tpu_torch.probes import gather2 as pg

    x = pg.probe_inputs(dev)
    for key in pg.LAUNCHES:  # the probes' path starts here
        pg.LAUNCHES[key] = 0
    outs = pg.run_probes(dev, x)
    torch.cuda.synchronize()
    launches = dict(pg.LAUNCHES)
    if launches != {k: 1 for k in pg.LAUNCHES}:
        raise AssertionError(f"probe2 launches {launches}")

    # bytes each must move: indices, the distinct table words they read,
    # output. P9's output is tbl[idx] on these finite inputs (checked
    # below), so it needs no arithmetic: the table, the indices and the
    # 4 MiB output
    n_idx = float(pg.S * pg.L)
    lane = torch.arange(pg.L, device=dev)
    idx_i = x["idx_i"].long()
    cas = torch.take_along_dim(idx_i >> 7, idx_i & (pg.L - 1), dim=1)
    words = dict(
        P6=torch.unique(x["idx_g"].long() * pg.L + lane).numel(),
        P7=torch.unique(x["idx_h"].long()
                        + pg.L * torch.arange(pg.S, device=dev)[:, None]
                        ).numel(),
        P8=torch.unique(cas * pg.L + lane).numel())
    bounds = {pid: bound(4.0 * (2 * n_idx + w), 0.0)
              for pid, w in words.items()}
    bounds["P9"] = bound(4.0 * (pg.L * pg.L + n_idx + n_idx * pg.L), 0.0)

    p9_out = torch.empty((pg.S, pg.L, pg.L), device=dev)
    kernels = dict(pg.PROBES, P9=lambda x: pg.onehot_matmul(
        x["tbl_j"], x["idx_j"], out=p9_out))  # one output buffer, reused
    library = probe2_library(x)
    probes = {}
    for pid, fn in kernels.items():
        want = pg.PLAIN[pid](x)
        if not torch.equal(outs[pid], want):
            raise AssertionError(f"{pid} differs from its plain version")
        if library[pid] is not None and not torch.equal(library[pid](),
                                                        want):
            raise AssertionError(f"{pid}'s library call differs")
        probes[pid] = dict(**timings(lambda: fn(x), lambda: pg.PLAIN[pid](x),
                                     library[pid]),
                           max_abs_err=0.0, **bounds[pid])
    matmul = library["P9 matmul"]
    if not torch.equal(matmul().reshape(outs["P9"].shape), outs["P9"]):
        raise AssertionError("P9 differs from torch.matmul")
    probes["P9"].update(matmul_ms=per_call_ms(matmul),
                        matmul_ms_single=time_ms(matmul))

    # P9 on a table of -0, +inf, -inf, NaN and an all-negative column, at
    # the probe's and at ragged row counts: equal values, NaN where the
    # plain version has NaN, equal sign bits off NaN
    special = {}
    for s in (pg.S, 1, 3, 65):
        sv = pg.special_inputs(s, dev)
        got = pg.onehot_matmul(sv["tbl"], sv["idx"])
        want = pg.onehot_matmul_plain(sv["tbl"], sv["idx"])
        torch.cuda.synchronize()
        if not pg.equal_off_nan(got, want):
            raise AssertionError(f"P9 differs from its plain version on "
                                 f"the special-values table, S = {s}")
        special[s] = dict(nan=int(want.isnan().sum()),
                          inf=int(want.isinf().sum()))
    out = dict(phase="probes2", C=pg.C, S=pg.S, L=pg.L, launches=launches,
               reps=K1_REPS, per_call=PER_CALL, probes=probes,
               p9_special=special)
    emit(out)
    return out


def material_scene(name: str, dev, resolution):
    """A config's camera and TracedScene on ``dev``, with the seconds of
    the scene build (meshes, environment tables, upload) and of
    TracedScene.create (BVH build, reorder, 32-wide collapse, upload),
    each synchronised."""
    import torch

    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.scene import procedural

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    sync()
    t0 = time.perf_counter()
    cam, sd = getattr(procedural, name)(resolution, device=dev)
    sync()
    t1 = time.perf_counter()
    scene = TracedScene.create(sd)
    sync()
    return cam, scene, t1 - t0, time.perf_counter() - t1


def phase_materials_golden(dev):
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    out = dict(phase="materials_golden")
    for config, (name, golden, depth, _) in MATERIAL_CONFIGS.items():
        films = {}
        for where in (torch.device("cpu"), dev):
            cam, scene, _, _ = material_scene(name, where, (64, 64))
            integ = PathIntegrator(PathConfig(max_depth=depth), spp=2,
                                   band_rows=16)
            before = (k1.LAUNCHES, k2.LAUNCHES)
            film = integ.render(cam, scene)
            if where.type == "cuda":
                torch.cuda.synchronize()
            launches = (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1])
            _, n_bands = integ.band_layout(cam)
            expect = (0, 0) if where.type == "cpu" else \
                (0, n_bands * integ.spp * (3 * depth + 1))
            if launches != expect:
                raise AssertionError(f"config {config} on {where} launched "
                                     f"(K1, K2) {launches} times, expected "
                                     f"{expect}")
            films[where.type] = (film.cpu().numpy(), launches[1],
                                 integ.last_ray_count)
        got, want = films["cuda"][0], films["cpu"][0]
        if not (np.isfinite(got).all() and (got[..., 3] > 0).all()):
            raise AssertionError(f"config {config}: card film must be "
                                 "finite with positive weight")
        ref = np.load(os.path.join(ROOT, "tests", golden))["film"]
        # tests/test_golden.py's _golden_check bar
        np.testing.assert_allclose(got[..., 3], ref[..., 3], rtol=1e-5)
        rmse_golden = float(np.sqrt(np.mean((got[..., :3]
                                             - ref[..., :3]) ** 2)))
        mean_rel = abs(float(got[..., :3].mean() - ref[..., :3].mean())) \
            / float(ref[..., :3].mean())
        if not (rmse_golden < 2e-3 and mean_rel < 0.02):
            raise AssertionError(f"config {config}: golden RMSE "
                                 f"{rmse_golden}, mean off by {mean_rel}")
        # the card against the port's own CPU film
        np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
        rmse_cpu = float(np.sqrt(np.mean((got[..., :3]
                                          - want[..., :3]) ** 2)))
        if not rmse_cpu < 1e-3:
            raise AssertionError(f"config {config}: card vs CPU RMSE "
                                 f"{rmse_cpu} >= 1e-3")
        diff = np.abs(got[..., :3] - want[..., :3]).max(axis=-1)
        out[config] = dict(scene=name, max_depth=depth,
                           rmse_golden=rmse_golden, mean_rel_golden=mean_rel,
                           rmse_cpu=rmse_cpu,
                           pixels_differing_cpu=int((diff > 0).sum()),
                           launches=films["cuda"][1],
                           rays_card=films["cuda"][2],
                           rays_cpu=films["cpu"][2])
    emit(out)
    return out


def k2_config_check(cam, scene, dev, depth: int) -> dict:
    """K2 against the plain traversal on a config's own table, on one
    wave of K2_RAYS camera rays drawn over the whole image (sample frame
    0, torch seed 0; a top band alone can be all sky): closest hit (t_max
    inf) and any hit (bounds of 0.5-1.5x the closest t, numpy seed 0)
    must agree bit for bit."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.accel.bvhw import bvhw_intersect as bvhw_plain
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2

    integ = PathIntegrator(PathConfig(max_depth=depth, mis_mode="onesample"),
                           spp=MAT_SPP, band_rows=1 << 20)  # one band
    o, d = first_band_rays(cam, integ, dev)[:2]
    gen = torch.Generator().manual_seed(0)
    pick = torch.randperm(d.shape[0], generator=gen)[:K2_RAYS].to(dev)
    o, d = o[pick].contiguous(), d[pick].contiguous()
    table, stackw = scene.bw_rows, scene.bw_depth
    t_inf = torch.full((o.shape[0],), torch.inf, device=dev)
    got = k2.bvhw_intersect(table, o, d, t_inf, stackw=stackw)
    want = bvhw_plain(table, o, d, t_inf, stackw=stackw)
    scale = torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.5, o.shape[0]).astype(np.float32), device=dev)
    t_any = torch.where(want["valid"], want["t"] * scale, 1.0)
    got_any = k2.bvhw_intersect(table, o, d, t_any, any_hit=True,
                                stackw=stackw)
    want_any = bvhw_plain(table, o, d, t_any, any_hit=True, stackw=stackw)
    torch.cuda.synchronize()
    for key in ("valid", "tri", "t", "b"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"K2 {key} differs from the plain version "
                                 "on this config's table")
    if not torch.equal(got_any, want_any):
        raise AssertionError("K2 any-hit differs from the plain version on "
                             "this config's table")
    # a closed room (config C) has no closest-hit misses; the any-hit
    # bounds give both outcomes in every config
    hit = want["valid"]
    if not bool(hit.any()) or bool(want_any.all()) \
            or not bool(want_any.any()):
        raise AssertionError("K2 check needs hits, and any-hit lanes of "
                             "both outcomes")
    return dict(rays=int(o.shape[0]), hit_lanes=int(hit.sum()),
                anyhit_lanes=int(want_any.sum()))


def phase_materials_main(dev, smi: str):
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    w, h = MAT_RES
    out = dict(phase="materials_main", resolution=list(MAT_RES),
               spp=MAT_SPP, mis_mode="onesample", card=smi)
    total = 0
    for config, (name, _, _, depth) in MATERIAL_CONFIGS.items():
        torch.cuda.reset_peak_memory_stats(dev)
        cam, scene, build_s, create_s = material_scene(name, dev, MAT_RES)
        cfg = PathConfig(max_depth=depth, mis_mode="onesample")
        t0 = time.perf_counter()
        PathIntegrator(cfg, spp=1).render(cam, scene)  # warm-up, 1 spp
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        integ = PathIntegrator(cfg, spp=MAT_SPP)
        _, n_bands = integ.band_layout(cam)
        expect = n_bands * integ.spp * (2 * depth + 1)

        film, runs = timed_renders(integ, cam, scene, {k2: expect, k1: 0},
                                   f"config {config}")
        launches, k1_launches = k2.LAUNCHES, k1.LAUNCHES
        if tuple(film.shape) != (h, w, 4):
            raise AssertionError(f"film shape {tuple(film.shape)}")
        if not bool(torch.isfinite(film).all()):
            raise AssertionError(f"config {config}: non-finite film")
        if not bool((film[..., 3] > 0).all()):
            raise AssertionError(f"config {config}: film weight must be "
                                 "positive everywhere")
        total += launches
        peak = torch.cuda.max_memory_allocated(dev)
        # after the render's figures: the plain traversal's memory is not
        # the render's
        k2_check = k2_config_check(cam, scene, dev, depth)
        out[config] = dict(
            scene=name, max_depth=depth,
            triangles=int(scene.tri_pack.shape[0]),
            table_rows=int(scene.bw_rows.shape[0]), depth=scene.bw_depth,
            bands=n_bands, **runs, warmup_1spp_seconds=warm_s,
            build_seconds=build_s, create_seconds=create_s,
            launches=launches, expected_launches=expect,
            k1_launches=k1_launches,
            peak_mem_bytes=peak,
            bad_samples=integ.bad_sample_count, k2_check=k2_check,
            film_mean_rgb=[float(v) for v in
                           film[..., :3].mean(dim=(0, 1)).cpu()])
    out["launches"] = total
    emit(out)
    return out


def box_render_profile(dev) -> dict:
    """One box-field render (phase 8's, after a warm-up render) under
    torch.profiler: the device time of all its kernels, K2's share of it,
    the launches, and the device's busy share of the traced render's wall
    time (the trace slows the host, so the share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator

    cam, scene, _ = box_scene(dev)
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=2)
    _, n_bands = integ.band_layout(cam)
    integ.render(cam, scene)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        integ.render(cam, scene)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    k2_events = [e for e in events if "bvhw_kernel" in e.key]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    k2_ms = sum(e.self_device_time_total for e in k2_events) / 1e3
    if device_ms <= 0 or not k2_events:
        raise AssertionError("profiler saw no device time for the render")
    launches = sum(e.count for e in events)
    return dict(device_ms=device_ms, k2_device_ms=k2_ms,
                k2_share=k2_ms / device_ms,
                k2_launches=sum(e.count for e in k2_events),
                launches=launches,
                launches_per_band_frame=launches / (n_bands * integ.spp),
                traced_wall_ms=wall_ms, device_busy_share=device_ms / wall_ms)


def phase_profile(dev):
    """Device times from a torch.profiler trace: K1's and K2's at the
    shapes of phases 3 and 6, P1-P9's and their library calls' at the
    probes' shapes (all the device work of a call); then a whole box-field
    render. It runs last: an active CUPTI trace slows every later launch
    of the host-bound render."""
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.probes import gather as pg
    from pathtracer_tpu_torch.probes import gather2 as pg2

    scene, o, d, t_max = k1_inputs(dev)
    k1_ms = kernel_device_ms(
        lambda: k1.intersect(o, d, t_max, scene.tri_pack),
        "intersect_kernel")
    scene, o, d, t_inf, t_any = k2_inputs(dev)
    k2_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(scene.bw_rows, o, d, t_inf,
                                  stackw=scene.bw_depth), "bvhw_kernel")
    k2_any_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(scene.bw_rows, o, d, t_any, any_hit=True,
                                  stackw=scene.bw_depth), "bvhw_kernel")
    scene, o, d, t_live, t_any = k2_bounce_inputs(dev)
    k2_bounce_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(scene.bw_rows, o, d, t_live,
                                  stackw=scene.bw_depth), "bvhw_kernel")
    k2_bounce_any_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(scene.bw_rows, o, d, t_any, any_hit=True,
                                  stackw=scene.bw_depth), "bvhw_kernel")
    x, x2 = pg.probe_inputs(dev), pg2.probe_inputs(dev)
    probe_ms, library_ms = {}, {}
    for probes, inputs, library in ((pg.PROBES, x, probe_library(x)),
                                    (pg2.PROBES, x2, probe2_library(x2))):
        for pid, fn in probes.items():
            probe_ms[pid] = kernel_device_ms(lambda: fn(inputs))
        for pid, fn in library.items():
            if fn is not None:
                library_ms[pid] = kernel_device_ms(fn)
    out = dict(phase="profile", k1_kernel_device_ms=k1_ms,
               k2_kernel_device_ms=k2_ms,
               k2_anyhit_kernel_device_ms=k2_any_ms,
               k2_bounce_kernel_device_ms=k2_bounce_ms,
               k2_bounce_anyhit_kernel_device_ms=k2_bounce_any_ms,
               probe_kernel_device_ms=probe_ms,
               library_device_ms=library_ms, reps=K1_REPS,
               box_render=box_render_profile(dev))
    emit(out)
    return out


def phase_build():
    """Compile every native source at once (one compiler process each)."""
    from pathtracer_tpu_torch.accel import cpp
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.probes import gather as pg
    from pathtracer_tpu_torch.probes import gather2 as pg2

    def timed(build):
        t0 = time.perf_counter()
        path = build()
        return os.path.relpath(path, ROOT), time.perf_counter() - t0

    builds = dict(pylaunch=_build.build_pylaunch,
                  intersect=lambda: k1.build(verbose=True),
                  bvhw=lambda: k2.build(verbose=True),
                  gather_probe=lambda: pg.build(verbose=True),
                  gather_probe2=lambda: pg2.build(verbose=True),
                  bvh_builder=cpp.library_path)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        done = {name: fut.result() for name, fut in futures.items()}
    k1._load()
    k2._load()
    pg._load()
    pg2._load()
    cpp._load()
    out = dict(phase="build", seconds=time.perf_counter() - t0,
               libraries={name: dict(path=path, seconds=sec)
                          for name, (path, sec) in done.items()})
    emit(out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    # before any output: without the package beside it, the script fails
    # having printed nothing
    import pathtracer_tpu_torch.integrator  # noqa: F401

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(dict(phase="device", name=name, nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              count=torch.cuda.device_count()))

    t_start = time.perf_counter()
    phase_build()
    k1_out = phase_k1(dev)
    phase_golden(dev)
    main_out = phase_main(dev, smi)
    k2_out = phase_k2(dev)
    phase_box_golden(dev)
    box_out = phase_box_main(dev, smi)
    probe_out = phase_probes(dev)
    probe2_out = phase_probes2(dev)
    phase_materials_golden(dev)
    mat_out = phase_materials_main(dev, smi)
    prof_out = phase_profile(dev)

    def times(d, device_ms, library_device_ms=None):
        """The kernels line's times of one kernel from its phase's
        figures ``d`` and the profile's device times."""
        return dict(ms=d["ms"], ms_single=d["ms_single"],
                    kernel_device_ms=device_ms, host_us=d["host_us"],
                    plain_ms=d["plain_ms"],
                    plain_ms_single=d["plain_ms_single"],
                    library_ms=d["library_ms"],
                    library_ms_single=d["library_ms_single"],
                    library_device_ms=library_device_ms,
                    bound_ms=d["bound_ms"], bound_by=d["bound_by"])

    probe_ms = prof_out["probe_kernel_device_ms"]
    library_ms = prof_out["library_device_ms"]
    probe_src = "pathtracer_tpu_torch/csrc/gather_probe.cu"
    probe_tool = "tools/probe_pallas_gather.py"
    kernels = [
        dict(name="intersect", route="cuda",
             source="pathtracer_tpu_torch/csrc/intersect.cu",
             replaces="pathtracer_tpu/ops/pallas/intersect_pl.py:52",
             launches=main_out["launches"],
             max_abs_err=max(k1_out["max_abs_err_t"],
                             k1_out["max_abs_err_b"]),
             **times(k1_out, prof_out["k1_kernel_device_ms"])),
        dict(name="bvhw", route="cuda",
             source="pathtracer_tpu_torch/csrc/bvhw.cu",
             replaces="pathtracer_tpu/accel/bvhw.py:596",
             launches=box_out["launches"],
             max_abs_err=max(k2_out["max_abs_err_t"],
                             k2_out["max_abs_err_b"]),
             launches_by_path=dict(box_main=box_out["launches"],
                                   materials_main=mat_out["launches"]),
             bounce=times(k2_out["bounce"],
                          prof_out["k2_bounce_kernel_device_ms"]),
             **times(k2_out, prof_out["k2_kernel_device_ms"]))]
    for pid, kernel, line in (("P1", "gather_rows", 65),
                              ("P2", "gather_rows", 78),
                              ("P3", "gather_cols", 92),
                              ("P4", "gather_rows_warp", 107),
                              ("P5", "stack_push_read", 130)):
        kernels.append(dict(
            name=f"{kernel} ({pid})", route="cuda", source=probe_src,
            replaces=f"{probe_tool}:{line}",
            launches=probe_out["launches"][kernel], max_abs_err=0.0,
            **times(probe_out["probes"][pid], probe_ms[pid],
                    library_ms.get(pid))))
    probe2_tool = "tools/probe_pallas_gather2.py"
    for pid, kernel, line in (("P6", "gather_sublane", 62),
                              ("P7", "gather_lane", 81),
                              ("P8", "gather_two_step", 102),
                              ("P9", "onehot_matmul", 145)):
        kernels.append(dict(
            name=f"{kernel} ({pid})", route="cuda",
            source="pathtracer_tpu_torch/csrc/gather_probe2.cu",
            replaces=f"{probe2_tool}:{line}",
            launches=probe2_out["launches"][kernel], max_abs_err=0.0,
            **times(probe2_out["probes"][pid], probe_ms[pid],
                    library_ms.get(pid))))
    p9 = probe2_out["probes"]["P9"]
    kernels[-1].update(matmul_ms=p9["matmul_ms"],
                       matmul_device_ms=library_ms["P9 matmul"])
    emit(dict(phase="total", seconds=time.perf_counter() - t_start))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
