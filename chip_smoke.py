#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printing one JSON line:

1. device  - the card's name and power limit (also printed raw, as
             nvidia-smi gives them);
2. build   - compiles kernel K1 (csrc/intersect.cu), kernel K2
             (csrc/bvhw.cu), kernels K3 and K4 (csrc/texture.cu: the
             texture evaluation and the alpha cut test, with their ptxas
             registers and spills), K5 / K6 (csrc/bsdf.cu), K7
             (csrc/sobol.cu) and the gather probes
             (csrc/gather_probe.cu,
             csrc/gather_probe2.cu) with nvcc, the launch module
             (csrc/pylaunch.c) with cc and the native BVH builder
             (csrc/bvh_builder.cpp) with g++, all at once; the registers,
             static shared memory and spills of P1-P5's and P6-P9's
             kernels from ptxas, their threads a block (P1_THREADS ...
             P5_THREADS), P4's rows a warp (P4_ROWS), P5's dynamic stack
             slab and P8's index rows a block (P8_ROWS, 128 threads each);
3. k1      - K1 against its plain PyTorch version on the card, at the main
             path's shapes (131,072 rays x cornell's 36 triangles, camera
             and shadow rays mixed): valid, tri, t, b and any-hit
             ``torch.equal``; then the same on the render set, the rays
             of the closest-hit query at bounce 2 of the last row band of
             a 640x480 cornell render (130,732 lanes, mostly dead: the
             band's padding rows and the finished paths), with the
             integrator's t_max (0 on lanes not active) and with t_max inf
             on every lane; all timed (below); K1's registers and spills
             from ptxas;
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
             values and sign bits elsewhere); P6, P7 and P8 at S = 64, 1,
             3, 65 and 0 index rows, and P8 on an idx view one word off
             16 bytes (its word path) at S = 64, 1, 3 and 65, exact;
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
             (both ray sets each and K2 on Sponza's alpha table, closest and
             any hit), K3's and K4's (phase 17b's calls), K5's and K6's
             (phase 17c's), P1-P9's and their
             library calls', P1-P5's at one lane (N = 1) and P6-P9's at
             one index row (S = 1): each kernel's launch floor,
             ``floor_device_ms`` in the kernels line;
             then one cornell render (as phase 5, at 2 spp) and one
             box-field render (as phase 8) under the profiler: the device
             time, K1's or K2's share of it and the launches (last, as
             tracing slows later launches).

Between phases 12 and 13 (which runs after every phase but 19 and
24-26), the classroom
(``data/classroom_proc.glb``: glTF, four PNG textures in the mip pool, ray
differentials, K2):

14. classroom_golden - 64x36, 2 spp, depth 5, "onesample" MIS on the
             card against the port's own CPU film at RMSE < 1e-3 and
             alpha rtol 1e-5, exact K2 launch count, no K1;
15. classroom_main - 1920x1080, 2 spp, depth 5, "onesample": load_gltf
             and TracedScene.create seconds (each synchronised), table
             rows and depth, then a warm-up render and three timed renders
             (as phase 5; exact K2 count, no K1), peak device memory,
             finite film with positive weight everywhere; then one render
             under torch.profiler (host and device activity): the device's
             busy share of its wall time, K2's share of the device time,
             K3's, and the share of the work launched inside
             ``eval_texture``'s ``pt::texture`` spans; K3's launches a
             render (the same in each, above 0).

Then Sponza (``data/sponza_proc.glb``: 123,592 triangles, 1,320 of them
alpha-masked and split out behind their own BVH32 table, re-spawn
retries) and the alpha routes it does not take:

16. sponza_golden - 48x27, 2 spp, depth 1, "ref" MIS (the golden's
             configuration) on the card against the port's CPU film (RMSE
             < 1e-3, alpha rtol 1e-5) and against
             tests/golden_sponza_48.npz at the reference's bar (weights
             rtol 1e-5, mean within 3 %, under 10 % of channels more than
             5 % off), exact K2 count (main table and alpha table), no K1,
             the retry loops' counts equal to the CPU's;
             then K2 on the alpha subset's table against its plain version
             on 131,072 rays through the foliage (half aimed at masked
             triangles, half in random directions), closest and any hit,
             ``torch.equal``, timed;
17. sponza_main - 1920x1080, 2 spp, depth 5, "onesample", as phase 15:
             load and create seconds, both tables' rows and depths,
             Mrays/s (three renders), peak memory, K2 launches a render
             split between the main table and the alpha table, the retry
             loops' host syncs and passes a band-frame, K3's launches a
             render and K4's (one after each alpha-table query);
17b. texture_kernels - K3 and K4 against their plain versions at the
             main path's shapes, each call's arguments taken from a render
             (``capture_texture_inputs``: the first K3 call with UV
             derivatives and the first without, 131,072 lanes, of a
             classroom and a Sponza render; Sponza's first K4 call) and
             K4 on phase 16's foliage rays through the alpha table: equal
             bits (cut equal), timed, with the bound (the lanes' inputs
             and outputs, the descriptor rows and tri_attr rows used, the
             texels the image lanes need: those the plain version gathers
             for them, each once);
17c. bsdf_kernels - K5 and K6 (csrc/bsdf.cu) against their plain
             versions (ops/bsdf.eval_world, sample_world) on the arguments
             of the first calls of a cornell-spheres render (depth 15,
             four materials) and of a cornell render (Matte only), taken
             by a spy on the eager path at 640x480 (130,732 lanes): every
             output ``torch.equal``, timed (ms over back-to-back calls,
             one call, host us, the plain version's ms; the device time
             in phase 13), with the bound (the bytes each lane's model
             reads and writes), and the launches of a 640x480 4-spp
             render of each;
17d. sobol_kernels - K7 (csrc/sobol.cu: the Sobol index and draws)
             against the plain chain (ops/sobol.py) on the 130,732 lanes
             of a 640x480 render's first band: the index and every
             dimension a depth-15 band-frame draws, one and two at a
             time, scrambled and not, ``torch.equal``; the index, a 1-D
             and a 2-D draw and the camera pair timed beside the plain
             chain (its device time in phase 13), with their byte
             bounds;
17e. env_kernels - K8 (csrc/env.cu: the environment light evaluated
             and sampled) against its plain twins (ops/lights.py
             env_eval_plain, env_sample_plain) on the arguments of every
             K8 call of a 640x480 tank-farm render's band 0, frame 3
             (130,732 lanes, depth 15), taken by a spy on the eager path:
             each output ``torch.equal``; the radiance, the pdf, both, and
             the sample timed (ms, one call, host us, device time) beside
             the plain twins, with their byte bounds; K8's launches in a
             tank-farm and a cornell render;
18. alpha_routes - at 131,072 lanes: the dense pass (512 masked
             triangles), closest and any hit, ms and peak bytes; the binary
             tree of an all-masked scene (1,024 triangles) against the
             dense pass on the same rays (equal hits and occlusion), ms of
             both; the brute-force route (K1 with re-spawn retries, exact
             K1 count); each held to the CPU on its first 16,384 lanes;
19. sponza_profile - after phase 13: one phase-17 render under
             torch.profiler (host and device): busy share, device events a
             band-frame, K2's, K3's and K4's device time and share, and
             what the ``alpha_cut`` ranges launch: one K4 kernel each and
             no kernel of a torch op.

Then, after phase 18, the paths of the Mitsuba importer's other arms,
the other samplers and the light tracer (the "slice_total" line gives
their seconds):

20. mitsuba_golden - the feature scene of tests/torch_mitsuba_scenes.py
             (cornell's walls and light, a dielectric and a rough-conductor
             sphere, a mirror cube, a rough-plastic floor, a checkerboard
             wall, a bitmap back wall, an OBJ of rough dielectric, an
             envmap with a transform; 392 triangles, K2) at 64x64, 2 spp,
             depth 3, "ref" MIS on the card against the port's CPU film
             (RMSE < 1e-3, alpha rtol 1e-5), exact K2 count, no K1;
21. mitsuba_main - the feature scene at 640x480, 16 spp, depth 5,
             "onesample": load and create seconds, a 1 spp warm-up, three
             timed renders (as phase 5; exact K2 count, no K1), peak
             memory, K3's launches a render;
22. samplers_main - cornell at 640x480, 16 spp, depth 5, "onesample"
             under the stratified sampler, the random one, and the
             stratified one with light_strategy="all": before each, a 32x32
             (2 spp, depth 3) card film against the CPU's at the same bar
             with exact K1 counts; then three timed renders each;
23. lighttrace - LightTracer(PathConfig(max_depth=5)) at the reference's
             2^20 paths in waves of 2^16 on cornell (K1) and on config B
             (point and distant lights, K2): a 32x32 card film of one wave
             against the CPU's on the same host-made draws (RMSE below
             1e-4 of the film's mean: the
             card's atomic adds reorder the sums, and its sqrt / sin / cos
             move the splats that land within an ulp of a pixel edge),
             then a warm-up and three timed 640x480 renders: Mrays/s and
             paths/s, peak memory, launches exactly waves x (2 depth + 1)
             (176 on cornell; config B has no area light, so its emission
             vertex connects to nothing: waves x 2 depth), and K3's
             launches a render (config B's checkered ground).

Last, after phase 19, the multi-device render, the command line and the
viewer (a second "slice_total" line gives their seconds):

24. sharded - ``parallel.mesh.render_sharded`` in ranks spawned by
             ``launch``, all on card 0, at 640x480, depth 5, "onesample":
             cornell (16 spp, K1) and config B (4 spp, K2) on one NCCL
             rank, films ``torch.equal`` to the single process's; cornell
             on two gloo ranks (NCCL takes one rank a card) and on a 2 x 2
             gloo mesh, and config B (4 spp, K2) on two gloo ranks, each
             held to the single process's card film at SHARD_ATOL /
             SHARD_RTOL; every rank's launches exactly its band's waves x
             its frames x a frame's queries (their sum beside the single
             process's count), each rank's wall time and the aggregate
             Mrays/s (the single process's rays over the slowest rank's
             seconds), beside the one-rank run's (a fresh process like
             every rank; this one has run every earlier phase);
25. cli    - ``python -m pathtracer_tpu_torch.frontend.cli`` on cornell
             160x120, 4 spp, depth 5, "onesample", four subprocesses at
             once: the render's PNG and that of ``--mesh 1`` (one NCCL
             rank) against ``to_rgb8`` of the same render here (at most 1
             apart in any byte; the count of differing bytes printed),
             ``--single_pixel 80,60`` (its logged mean
             against ``render_single_pixel`` here, rtol 1e-5) and
             ``--profile`` (a Chrome trace written, bounce 0's logged
             occupancy equal to the camera lanes);
26. viewer - ``preview_frame`` of cornell (one K1 launch) and config B
             (one K2 launch) at 160x120 against the CPU's (atol 1e-4), the
             BVH overlay on config B, one ``run`` with stdin /dev/null, no
             tev and ``max_frames=1`` (a PNG, a finite film with positive
             weight, exact K1 launches), and the keys r ] h o x through
             ``dispatch_key`` with the camera h moved rendered on the card.

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

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
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
# traces ``kernel_device_ms`` takes before it gives up on an empty one
PROFILE_ATTEMPTS = 3
# samples of the profiled cornell render: phase 5's 16 give a trace of
# ~673,000 device events, costly to process on the host; K1's share is
# that of every sample
PROFILE_CORNELL_SPP = 2
CLASSROOM = os.path.join(ROOT, "data", "classroom_proc.glb")
CLASS_RES = (1920, 1080)
CLASS_SPP = 2
SPONZA = os.path.join(ROOT, "data", "sponza_proc.glb")
SPONZA_GOLDEN = os.path.join(ROOT, "tests", "golden_sponza_48.npz")
SPONZA_RES = (1920, 1080)
SPONZA_SPP = 2
# lanes of the alpha routes' calls (a whole wave), and of the CPU's share
# of them that the card's answers are held to (lanes are independent)
ALPHA_RAYS = 1 << 17
ALPHA_CPU_RAYS = 1 << 14
# timed calls of a plain-torch alpha route (host loops, a sync a pass)
ALPHA_ROUTE_REPS = 5
# the Mitsuba feature scene (tests/torch_mitsuba_scenes.py) and the
# stratified / random samplers and all-lights strategy on cornell, at the
# cornell main path's size
SLICE_RES = (640, 480)
SLICE_SPP = 16
SAMPLER_CONFIGS = (("stratified", "one"), ("random", "one"),
                   ("stratified", "all"))
# the light tracer at the reference's defaults
LT_RES = (640, 480)
LT_PATHS = 1 << 20
LT_WAVE = 1 << 16
LT_DEPTH = 5
# its card-vs-CPU check at 32x32: one wave (the CPU runs config B's
# traversal in plain torch, ~11 s a wave), held at an RMSE below
# LT_CHECK_RMSE of the film's mean. The card's atomic adds reorder each
# pixel's sum (~1e-7 of it, config B's whole difference), and its sqrt /
# sin / cos round unlike the CPU's, which moves a rare splat or path that
# lands within an ulp of an edge (each ~1/400 of a pixel's value at one
# wave): cornell measured 1.09e-5 of the mean at one wave, 8.1e-5 at four
LT_CHECK_PATHS = 1 << 16
LT_CHECK_RMSE = 1e-4
# the sharded renders: cornell at the main path's configuration and
# config B (K2) at materials_main's spp, in ranks spawned on card 0
SHARD_RES = (640, 480)
SHARD_SPP = 16
SHARD_B_SPP = 4
# their films against the single process's card film, where only the
# order of the sums differs: atol 5e-5 is the JAX package's bar for its
# sharded render at 1-2 spp; at 16 spp cornell's light pixels sum to ~340,
# where a reordered sum moves a few ulps (a 2 x 2 mesh at 16 spp measured
# 6.1e-5 absolute, 3.1e-7 relative, on the CPU), hence the rtol
SHARD_ATOL = 5e-5
SHARD_RTOL = 1e-6
# the command line's cornell render, on one NCCL rank too, its
# single-pixel trace and its profile (four subprocesses at once), and the
# viewer's frames
CLI_RES = (160, 120)
CLI_SPP = 4
CLI_PIXEL = (80, 60)
CLI_TIMEOUT = 300
VIEW_RES = (160, 120)

# calls of K3's / K4's plain version in a per-call time (each call is a
# chain of ~100-230 small kernels)
PLAIN_TEX_CALLS = 20
# FP32 operations of K3 / K4 as csrc/texture.cu writes them (a
# transcendental or a floor counted as one): the UV map (4) a lane; a
# bilinear level (s, t, floors, fractions and their complements: 10; 3
# channels of 8 products and 3 sums: 33); the width mode's width, level
# and fraction (21) and its blend of two levels (9); an image lane's sRGB
# decode (4 a channel) and scale (3); a K4 lane's hit point (15) and
# error bound (9 more), and a tested lane's uv (10)
TEX_UV_OPS = 4
TEX_LEVEL_OPS = 43
TEX_WIDTH_OPS = 30
TEX_IMAGE_OPS = 15
CUT_OPS = 24
CUT_UV_OPS = 10

# the H100 SXM's published peaks (NVIDIA data sheet; 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations every ray-triangle pair pays in the watertight test
# before its early exit: 9 translations, 6 shear multiply-adds (12) and
# 3 edge functions of two products and a difference (9). The kernels are
# built unfused (-fmad=false), so each is one instruction: they reach at
# most half the FMA peak of 67 TFLOP/s that the bound divides by
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


def ray_bytes(n: int, live: int) -> float:
    """The bytes an intersection query of ``n`` lanes must move for its
    rays, ``live`` of them with a t_max > 0: each lane's t_max (4 B) and
    its record (valid, t, tri, b: 21 B), and a live lane's o and d (24 B).
    A lane whose t_max is not > 0 is a miss whatever its ray, so the
    function needs no more of it."""
    return 25.0 * n + 24.0 * live


def max_abs_err(pairs) -> float:
    """The largest |got - want| over ``(got, want)`` tensor pairs, 0 where
    the two are equal (infinities included)."""
    import torch
    err = 0.0
    for got, want in pairs:
        diff = (got.double() - want.double()).abs()
        diff = torch.where(got == want, 0.0, diff)
        if diff.numel():
            err = max(err, float(diff.max()))
    return err


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
    launches on the scene's main table, or K1's}) and the integrator's
    ``RETRY_COUNTS`` set to 0 just before it and checked just after it;
    K2's count must also hold one launch for each query of an alpha
    subset's table (``RETRY_COUNTS["alpha_tree"]``, which depends on the
    data). Returns the last film and the renders' figures: Mrays/s as the
    median, min and max of the renders, with each render's seconds, and
    each render's retry counts; kernels K3's and K4's launches a render
    (the same in every render; K4's one for each alpha-table query), K5's
    and K6's (``bsdf_launches``: exactly those of a render's shading
    bounces), K7's (``sobol_launches``: exactly a render's Sobol draws)
    and K8's (``env_launches``: exactly a render's calls of the
    environment's code)."""
    import torch

    from pathtracer_tpu_torch import integrator as pint
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    try:
        from pathtracer_tpu_torch.ops.cuda import texture_cu as tx
    except ImportError:  # a checkout from before K3 / K4 (kernel_ab.py)
        tx = types.SimpleNamespace(LAUNCHES={})
    try:
        from pathtracer_tpu_torch.ops.cuda import bsdf_cu
        want_bsdf = bsdf_launches(integ, cam, scene)
    except ImportError:  # a checkout from before K5 / K6 (kernel_ab.py)
        bsdf_cu, want_bsdf = types.SimpleNamespace(LAUNCHES={}), {}
    try:
        from pathtracer_tpu_torch.ops.cuda import sobol_cu
        want_sobol = sobol_launches(integ, cam, scene)
    except ImportError:  # a checkout from before K7 (kernel_ab.py)
        sobol_cu, want_sobol = types.SimpleNamespace(LAUNCHES={}), {}
    try:
        from pathtracer_tpu_torch.ops.cuda import env_cu
        want_env = env_launches(integ, cam, scene)
    except ImportError:  # a checkout from before K8 (kernel_ab.py)
        env_cu, want_env = types.SimpleNamespace(LAUNCHES={}), {}
    seconds, retry, texture = [], [], []
    for _ in range(RENDER_REPS):
        for mod in expect:
            mod.LAUNCHES = 0  # the main path's run starts here
        for counts in (tx.LAUNCHES, bsdf_cu.LAUNCHES, sobol_cu.LAUNCHES,
                       env_cu.LAUNCHES):
            for key in counts:
                counts[key] = 0
        for key in pint.RETRY_COUNTS:
            pint.RETRY_COUNTS[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = integ.render(cam, scene)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        retry.append(dict(pint.RETRY_COUNTS))
        texture.append(dict(tx.LAUNCHES))
        got = {mod.__name__.rsplit(".", 1)[-1]: mod.LAUNCHES for mod in expect}
        want = {mod.__name__.rsplit(".", 1)[-1]:
                n + (pint.RETRY_COUNTS["alpha_tree"] if mod is k2 else 0)
                for mod, n in expect.items()}
        if got != want:
            raise AssertionError(f"{what} render launched {got}, expected "
                                 f"{want}")
        # K4 once after each query of the alpha subset's table (these
        # scenes' only alpha route), K3 the same number every render
        if tx.LAUNCHES and (
                tx.LAUNCHES["alpha_cut"] != pint.RETRY_COUNTS["alpha_tree"]
                or texture[-1]["texture_eval"] != texture[0]["texture_eval"]):
            raise AssertionError(f"{what} render launched K3 / K4 "
                                 f"{texture}, alpha-table queries "
                                 f"{pint.RETRY_COUNTS['alpha_tree']}")
        if bsdf_cu.LAUNCHES != want_bsdf:
            raise AssertionError(f"{what} render launched K5 / K6 "
                                 f"{bsdf_cu.LAUNCHES}, expected {want_bsdf}")
        if sobol_cu.LAUNCHES != want_sobol:
            raise AssertionError(f"{what} render launched K7 "
                                 f"{sobol_cu.LAUNCHES}, expected "
                                 f"{want_sobol}")
        if env_cu.LAUNCHES != want_env:
            raise AssertionError(f"{what} render launched K8 "
                                 f"{env_cu.LAUNCHES}, expected {want_env}")
    rates = [integ.last_ray_count / dt / 1e6 for dt in seconds]
    return film, dict(rays=integ.last_ray_count,
                      seconds=statistics.median(seconds),
                      seconds_runs=seconds,
                      mrays_per_s=statistics.median(rates),
                      mrays_per_s_min=min(rates), mrays_per_s_max=max(rates),
                      renders=RENDER_REPS, retry_counts_runs=retry,
                      texture_launches=texture[-1],
                      bsdf_launches=dict(bsdf_cu.LAUNCHES),
                      sobol_launches=dict(sobol_cu.LAUNCHES),
                      env_launches=dict(env_cu.LAUNCHES))


def bsdf_launches(integ, cam, scene) -> dict:
    """K5's and K6's launches in one render: in each band-frame's shading
    bounces (every bounce but the last), one ``bsdf_eval`` a light NEE
    samples and one ``bsdf_sample`` for the scatter ("ref" MIS: and one
    more a light sampled)."""
    from pathtracer_tpu_torch.integrator import _wave_flags

    cfg = integ.cfg
    do_nee, one_sample, _ = _wave_flags(scene, cfg)
    _, n_bands = integ.band_layout(cam)
    lights = scene.n_lights if cfg.light_strategy == "all" else 1
    nee = lights if do_nee else 0
    bounces = n_bands * integ.spp * cfg.max_depth
    return dict(bsdf_eval=bounces * nee,
                bsdf_sample=bounces * (1 + (0 if one_sample else nee)))


def sobol_launches(integ, cam, scene) -> dict:
    """K7's launches in one render: none under the hash samplers; under
    the Sobol sampler, in each band-frame the index, the camera pair and
    the draws of each shading bounce (every bounce but the last,
    ``_wave_bounce``): NEE's u_light pair ("ref" MIS: and its u_scatter
    pair; light_strategy "all": those of each light; "one": and the light
    pick where the scene has more than one light), the BSDF's u_bsdf pair,
    and roulette's draw at the bounces above ``rr_start_depth``."""
    from pathtracer_tpu_torch.integrator import _wave_flags

    cfg = integ.cfg
    if cfg.sampler != "sobol":
        return dict(sobol_index=0, sobol_draw=0)
    do_nee, one_sample, _ = _wave_flags(scene, cfg)
    _, n_bands = integ.band_layout(cam)
    pairs = 1 if one_sample else 2
    if not do_nee:
        nee = 0
    elif cfg.light_strategy == "all":
        nee = pairs * scene.n_lights
    else:
        nee = pairs + (scene.n_lights > 1)
    roulette = max(cfg.max_depth - 1 - cfg.rr_start_depth, 0) \
        if cfg.rr_enable else 0
    frames = n_bands * integ.spp
    return dict(sobol_index=frames,
                sobol_draw=frames * (1 + cfg.max_depth * (nee + 1)
                                     + roulette))


def env_launches(integ, cam, scene) -> dict:
    """K8's launches in one render: none in a scene without an
    environment; with one, in each band-frame one ``env_eval`` a bounce
    for the escaped rays (their radiance, and from bounce 1 under
    one-sample MIS its density in the same launch), and at each shading
    bounce (every bounce but the last) with NEE, for each light sample
    (light_strategy "all": one a light), one ``env_sample`` where the
    scene's lights include the environment and, under "ref" MIS, one
    ``env_eval`` for the BSDF sample's light density (the environment
    among the lights) and one for its radiance."""
    from pathtracer_tpu_torch.integrator import _wave_flags
    from pathtracer_tpu_torch.scene.scene import LIGHT_INFINITE

    cfg = integ.cfg
    if not scene.has_env:
        return dict(env_eval=0, env_sample=0)
    do_nee, one_sample, _ = _wave_flags(scene, cfg)
    _, n_bands = integ.band_layout(cam)
    frames = n_bands * integ.spp
    if not do_nee:
        samples = 0
    else:
        samples = frames * cfg.max_depth * (
            scene.n_lights if cfg.light_strategy == "all" else 1)
    infinite = int(LIGHT_INFINITE in scene.light_set)
    ref_evals = 0 if one_sample else infinite + 1
    return dict(env_eval=frames * (cfg.max_depth + 1) + samples * ref_evals,
                env_sample=samples * infinite)


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
    host's per-call dispatch gaps that CUDA events around a call count.
    A trace that holds none of it is reported on stderr and taken again,
    up to PROFILE_ATTEMPTS traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        us = sum(e.self_device_time_total for e in events
                 if name is None or name in e.key)
        if us > 0:
            return us / reps / 1e3
        seen = [e.key for e in events][:8]
        print(f"kernel_device_ms: trace {attempt + 1} of "
              f"{PROFILE_ATTEMPTS} held no device time for {name} (it "
              f"held {seen})", file=sys.stderr, flush=True)
    raise AssertionError(f"profiler saw no device time for {name}")


@contextlib.contextmanager
def eager_band_frames():
    """Inside, every render runs its band-frames eagerly, the CUDA graph
    off (``integrator._graph_engages``): a spy in the bounce loop then
    sees each band-frame's own tensors, computed, and may stop the
    render, where a capture would hand it buffers whose values a replay
    overwrites."""
    from pathtracer_tpu_torch import integrator as pint

    engages = pint._graph_engages
    pint._graph_engages = lambda scene, cfg: False
    try:
        yield
    finally:
        pint._graph_engages = engages


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


def k1_render_inputs(dev, bounce: int = 2, resolution=(640, 480)):
    """K1's second ray set, the rays of a render: the closest-hit query
    at bounce ``bounce`` of the last row band of a 640x480 cornell render
    (phase 5's configuration at 1 spp): 203 rows of 644 lanes, of which
    the rows below the image are padding, dead from the start, and the
    paths that ended are dead too. Returns (scene, o, d, t_live, t_inf):
    t_live the integrator's rule (inf on the active lanes, 0 on the
    others), t_inf inf on every lane."""
    import torch

    from pathtracer_tpu_torch import integrator as im
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(CORNELL, resolution=resolution, device=dev)
    scene = im.TracedScene.create(sd)
    integ = im.PathIntegrator(im.PathConfig(max_depth=5,
                                            mis_mode="onesample"), spp=1)
    seen, wave_bounce = [], im._wave_bounce

    def record(scene_, cfg, b, st, draw, draw2, **kw):
        if b == bounce:
            seen.append((st["o"], st["d"], st["active"]))
        return wave_bounce(scene_, cfg, b, st, draw, draw2, **kw)
    im._wave_bounce = record
    try:
        with eager_band_frames():
            integ.render(cam, scene)
    finally:
        im._wave_bounce = wave_bounce
    o, d, active = seen[-1]  # the last band
    t_inf = torch.full((o.shape[0],), torch.inf, device=dev)
    return (scene, o.contiguous(), d.contiguous(),
            torch.where(active, torch.inf, 0.0), t_inf)


def k1_check(o, d, t_max, tri_pack, what: str):
    """K1 against its plain version, closest and any hit: every output
    ``torch.equal``. Returns (plain closest hit, plain any hit, the
    largest |error| of t and b)."""
    import torch

    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    got = k1.intersect(o, d, t_max, tri_pack)
    got_any = k1.intersect(o, d, t_max, tri_pack, any_hit=True)
    want = k1.intersect_plain(o, d, t_max, tri_pack)
    want_any = k1.intersect_plain(o, d, t_max, tri_pack, any_hit=True)
    torch.cuda.synchronize()
    for key in ("valid", "tri", "t", "b"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"K1 {key} differs from the plain version "
                                 f"({what})")
    if not torch.equal(got_any, want_any):
        raise AssertionError(f"K1 any-hit differs from the plain version "
                             f"({what})")
    hit = want["valid"]
    if int(hit.sum()) == 0 or bool(hit.all()):
        raise AssertionError(f"K1 inputs need both hits and misses ({what})")
    err = max_abs_err((got[key], want[key]) for key in ("t", "b"))
    return want, want_any, err


def k1_registers() -> dict:
    """K1's registers and spills a kernel (closest, any hit), from the
    ptxas report of its build."""
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    report = _build.ptxas_report(k1.build())
    return {("any_hit" if "ILb1E" in name else "closest"): regs
            for name, regs in report.items() if "intersect_kernel" in name}


def phase_k1(dev, k1_sets: dict):
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    scene, o, d, t_max = k1_sets["k1"]
    tri_pack = scene.tri_pack
    n, f = o.shape[0], tri_pack.shape[0]
    n_live = int((t_max > 0).sum())
    want, want_any, err = k1_check(o, d, t_max, tri_pack,
                                   "camera and shadow")
    hit = want["valid"]
    times = timings(lambda: k1.intersect(o, d, t_max, tri_pack),
                    lambda: k1.intersect_plain(o, d, t_max, tri_pack))
    ms_any = time_ms(lambda: k1.intersect(o, d, t_max, tri_pack,
                                          any_hit=True))
    plain_ms_any = time_ms(lambda: k1.intersect_plain(
        o, d, t_max, tri_pack, any_hit=True))

    # the render set, with the integrator's t_max and with inf everywhere
    _, ro, rd, t_live, t_inf = k1_sets["render"]
    rn, live = ro.shape[0], int((t_live > 0).sum())
    r_want, _, r_err = k1_check(ro, rd, t_live, tri_pack, "render")
    r_inf_err = k1_check(ro, rd, t_inf, tri_pack, "render, t_max inf")[2]
    # the rays (``ray_bytes``: dead lanes only their t_max and record) and
    # the (F, 12) table; a pair test for each live lane and triangle
    render = dict(rays=rn, live_lanes=live,
                  hit_lanes=int(r_want["valid"].sum()),
                  **bound(ray_bytes(rn, live) + 48.0 * f,
                          PAIR_OPS * float(live) * f),
                  **timings(lambda: k1.intersect(ro, rd, t_live, tri_pack),
                            lambda: k1.intersect_plain(ro, rd, t_live,
                                                       tri_pack),
                            # 3-4 ms a call: as few calls as K2's plain
                            plain_calls=PLAIN_K2_REPS,
                            plain_reps=PLAIN_K2_REPS),
                  ms_t_inf=per_call_ms(lambda: k1.intersect(ro, rd, t_inf,
                                                            tri_pack)),
                  ms_single_t_inf=time_ms(lambda: k1.intersect(
                      ro, rd, t_inf, tri_pack)))
    # as the render set's
    out = dict(phase="k1", rays=n, live_lanes=n_live, triangles=f,
               hit_lanes=int(hit.sum()),
               **bound(ray_bytes(n, n_live) + 48.0 * f,
                       PAIR_OPS * float(n_live) * f),
               anyhit_lanes=int(want_any.sum()),
               max_abs_err=max(err, r_err, r_inf_err), **times,
               ms_anyhit=ms_any,
               plain_ms_anyhit=plain_ms_any, reps=K1_REPS,
               per_call=PER_CALL, mrays_per_s=n / times["ms"] / 1e3,
               render=render, registers=k1_registers())
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
    # the rays (``ray_bytes``) and the table; the closest-hit query's
    # work: a slab test per occupied child of each interior row visited, a
    # pair test per real triangle of each leaf row visited
    live = int((t_max > 0).sum())
    out.update(rays=n, live_lanes=live, rows_visited=rows,
               rows_visited_anyhit=rows_any,
               **bound(ray_bytes(n, live) + table.numel() * 4.0,
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


def one_lane(x) -> dict:
    """The inputs ``x`` of P1-P5 cut to their first lane (N = 1): what a
    probe costs at one lane is its launch floor."""
    return dict(x, idx=x["idx"][:1], sp=x["sp"][:1], v=x["v"][:1])


def one_row(x) -> dict:
    """The inputs ``x`` of P6-P9 cut to their first index row (S = 1, and
    P7's data to its first row): the smallest input each takes, and its
    launch floor."""
    return dict(x, idx_g=x["idx_g"][:1], data_h=x["data_h"][:1],
                idx_h=x["idx_h"][:1], idx_i=x["idx_i"][:1],
                idx_j=x["idx_j"][:1])


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
                                     library[pid]),
                           max_abs_err=max_abs_err([(outs[pid], want)]),
                           **bounds[pid])
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
                           max_abs_err=max_abs_err([(outs[pid], want)]),
                           **bounds[pid])
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

    # P6-P8 at ragged row counts; P8 on an idx one word off 16 bytes
    ragged = []
    for s, offset, pids in ([(s, 0, ("P6", "P7", "P8"))
                             for s in (pg.S, 1, 3, 65, 0)]
                            + [(s, 1, ("P8",)) for s in (pg.S, 1, 3, 65)]):
        xr = pg.ragged_inputs(s, dev, offset)
        if s and xr["idx_i"].data_ptr() % 16 != 4 * offset:
            raise AssertionError("P8's idx view is not at its offset")
        for pid in pids:
            got = pg.PROBES[pid](xr)
            torch.cuda.synchronize()
            if got.shape != (s, pg.L) or not torch.equal(
                    got, pg.PLAIN[pid](xr)):
                raise AssertionError(f"{pid} differs from its plain version "
                                     f"at S = {s}, idx offset {offset}")
        ragged.append(dict(S=s, idx_offset_words=offset, probes=pids))
    out = dict(phase="probes2", C=pg.C, S=pg.S, L=pg.L, launches=launches,
               reps=K1_REPS, per_call=PER_CALL, probes=probes,
               p9_special=special, ragged=ragged)
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


def classroom_scene(dev, resolution=CLASS_RES, path=CLASSROOM):
    """A glTF scene's (classroom's by default) camera and TracedScene on
    ``dev``, with the seconds of load_gltf (glTF parse, PNG decode, mip
    pool, upload) and of TracedScene.create (BVH build, reorder, 32-wide
    collapse, alpha split, upload), each synchronised."""
    import torch

    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.scene.gltf import load_gltf

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    sync()
    t0 = time.perf_counter()
    cam, sd, _ = load_gltf(path, resolution=resolution, device=dev)
    sync()
    t1 = time.perf_counter()
    scene = TracedScene.create(sd)
    sync()
    return cam, scene, t1 - t0, time.perf_counter() - t1


def phase_classroom_golden(dev):
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    films = {}
    for where in (torch.device("cpu"), dev):
        cam, scene, _, _ = classroom_scene(where, resolution=(64, 36))
        integ = PathIntegrator(cfg, spp=2)
        k1_before, k2_before = k1.LAUNCHES, k2.LAUNCHES
        film = integ.render(cam, scene)
        if where.type == "cuda":
            torch.cuda.synchronize()
        _, n_bands = integ.band_layout(cam)
        launches = (k1.LAUNCHES - k1_before, k2.LAUNCHES - k2_before)
        expect = (0, 0) if where.type == "cpu" else \
            (0, n_bands * integ.spp * (2 * cfg.max_depth + 1))
        if launches != expect:
            raise AssertionError(f"classroom golden on {where} launched (K1, "
                                 f"K2) {launches} times, expected {expect}")
        films[where.type] = (film.cpu().numpy(), launches[1],
                             integ.last_ray_count)
    got, want = films["cuda"][0], films["cpu"][0]
    if not (np.isfinite(got).all() and (got[..., 3] > 0).all()):
        raise AssertionError("classroom golden film must be finite with "
                             "positive weight")
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = float(np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2)))
    if not rmse < 1e-3:
        raise AssertionError(f"classroom golden RMSE {rmse} >= 1e-3")
    diff = np.abs(got[..., :3] - want[..., :3]).max(axis=-1)
    out = dict(phase="classroom_golden", rmse=rmse,
               alpha_max_rel=float(np.max(np.abs(got[..., 3] - want[..., 3])
                                          / np.abs(want[..., 3]))),
               pixels_differing=int((diff > 0).sum()),
               max_pixel_diff=float(diff.max()), launches=films["cuda"][1],
               rays_card=films["cuda"][2], rays_cpu=films["cpu"][2],
               film_mean_rgb=[float(v) for v in got[..., :3].mean((0, 1))])
    emit(out)
    return out


def phase_classroom_main(dev, smi: str):
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    torch.cuda.reset_peak_memory_stats(dev)
    cam, scene, load_s, create_s = classroom_scene(dev)
    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    integ = PathIntegrator(cfg, spp=CLASS_SPP)
    _, n_bands = integ.band_layout(cam)
    expect = n_bands * integ.spp * (2 * cfg.max_depth + 1)

    t0 = time.perf_counter()
    integ.render(cam, scene)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    film, runs = timed_renders(integ, cam, scene, {k2: expect, k1: 0},
                               "classroom")
    launches = k2.LAUNCHES
    w, h = CLASS_RES
    if tuple(film.shape) != (h, w, 4):
        raise AssertionError(f"film shape {tuple(film.shape)}")
    if not bool(torch.isfinite(film).all()):
        raise AssertionError("film has non-finite values")
    if not bool((film[..., 3] > 0).all()):
        raise AssertionError("film weight must be positive everywhere")
    peak = torch.cuda.max_memory_allocated(dev)
    table = scene.bw_rows
    out = dict(phase="classroom_main", resolution=list(CLASS_RES),
               triangles=int(scene.tri_pack.shape[0]),
               textures=int(scene.data.tex.n_levels.shape[0]),
               pool_texels=int(scene.data.tex.data.shape[0]),
               table_rows=int(table.shape[0]),
               table_bytes=table.numel() * table.element_size(),
               depth=scene.bw_depth, spp=integ.spp,
               max_depth=cfg.max_depth, mis_mode=cfg.mis_mode,
               bands=n_bands, **runs, warmup_seconds=warm_s,
               load_seconds=load_s, create_seconds=create_s,
               launches=launches, expected_launches=expect,
               k1_launches=k1.LAUNCHES, peak_mem_bytes=peak,
               bad_samples=integ.bad_sample_count,
               film_mean_rgb=[float(v) for v in
                              film[..., :3].mean(dim=(0, 1)).cpu()],
               card=smi)
    if not runs["texture_launches"]["texture_eval"] > 0:
        raise AssertionError("classroom render never launched K3")
    out["profile"] = render_profile(cam, scene, CLASS_SPP, "bvhw_kernel",
                                    annotation="pt::texture",
                                    warmup=False,
                                    kernels=("texture_eval_kernel",))
    emit(out)
    return out, cam, scene


def foliage_rays(scene, n: int, dev, seed: int = 0):
    """Rays through a scene's masked triangles: half aimed at random
    points of random masked triangles from 0.5 to 3 units away, half from
    the same origins in random directions (most miss the foliage). Returns
    (o, d, t_inf, t_any) on ``dev``, t_any a random bound in [0.5, 6)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sd = scene.data
    masked = np.nonzero(sd.tri_alpha_txd.cpu().numpy() >= 0)[0]
    tri = rng.choice(masked, n)
    w = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    p = [x.cpu().numpy()[tri] for x in (sd.p0, sd.p1, sd.p2)]
    target = w[:, 0:1] * p[0] + w[:, 1:2] * p[1] + w[:, 2:3] * p[2]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = target - d * rng.uniform(0.5, 3.0, (n, 1))
    d_rnd = rng.normal(size=(n // 2, 3))
    d[n // 2:] = d_rnd / np.linalg.norm(d_rnd, axis=-1, keepdims=True)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (t(o), t(d), torch.full((n,), torch.inf, device=dev),
            t(rng.uniform(0.5, 6.0, n)))


def phase_sponza_golden(dev):
    import types

    import numpy as np
    import torch

    from pathtracer_tpu_torch import integrator as pint
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    cfg = PathConfig(max_depth=1)  # the golden's configuration ("ref")
    films = {}
    for where in (torch.device("cpu"), dev):
        cam, scene, _, _ = classroom_scene(where, resolution=(48, 27),
                                           path=SPONZA)
        integ = PathIntegrator(cfg, spp=2)
        k1_before, k2_before = k1.LAUNCHES, k2.LAUNCHES
        for key in pint.RETRY_COUNTS:
            pint.RETRY_COUNTS[key] = 0
        film = integ.render(cam, scene)
        if where.type == "cuda":
            torch.cuda.synchronize()
        _, n_bands = integ.band_layout(cam)
        launches = (k1.LAUNCHES - k1_before, k2.LAUNCHES - k2_before)
        # the main table: closest, shadow and BSDF-branch queries at each
        # bounce but the last, its closest; plus the alpha table's queries
        expect = (0, 0) if where.type == "cpu" else \
            (0, n_bands * integ.spp * (3 * cfg.max_depth + 1)
             + pint.RETRY_COUNTS["alpha_tree"])
        if launches != expect:
            raise AssertionError(f"Sponza golden on {where} launched (K1, "
                                 f"K2) {launches} times, expected {expect}")
        films[where.type] = (film.cpu().numpy(), launches[1],
                             integ.last_ray_count, dict(pint.RETRY_COUNTS))
    got, want = films["cuda"][0], films["cpu"][0]
    if not (np.isfinite(got).all() and (got[..., 3] > 0).all()):
        raise AssertionError("Sponza golden film must be finite with "
                             "positive weight")
    # K4's cut flags are the plain version's: the same retries
    if films["cuda"][3] != films["cpu"][3]:
        raise AssertionError(f"Sponza golden retry counts: card "
                             f"{films['cuda'][3]}, CPU {films['cpu'][3]}")
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = float(np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2)))
    if not rmse < 1e-3:
        raise AssertionError(f"Sponza card vs CPU RMSE {rmse} >= 1e-3")
    # the reference's test_sponza_glb_golden bar against the JAX film
    ref = np.load(SPONZA_GOLDEN)["film"]
    np.testing.assert_allclose(got[..., 3], ref[..., 3], rtol=1e-5)
    f, r = got[..., :3], ref[..., :3]
    mean_rel = float(abs(f.mean() - r.mean()) / r.mean())
    off = float((np.abs(f - r) / (np.abs(r) + 5e-2) > 0.05).mean())
    if not (abs(f.mean() - r.mean()) < 0.03 * r.mean() + 1e-4
            and off < 0.10):
        raise AssertionError(f"Sponza film against its golden: mean off by "
                             f"{mean_rel}, {off} of channels > 5 % off")
    # K2 on the alpha subset's table against its plain traversal
    o, d, t_inf, t_any = foliage_rays(scene, ALPHA_RAYS, dev)
    alpha_table = types.SimpleNamespace(bw_rows=scene.bwa_rows,
                                        bw_depth=scene.bwa_depth)
    k2_alpha = k2_ray_set("foliage", alpha_table, o, d, t_inf, t_any,
                          check_k1=False)
    out = dict(phase="sponza_golden", rmse=rmse,
               alpha_max_rel=float(np.max(np.abs(got[..., 3] - want[..., 3])
                                          / np.abs(want[..., 3]))),
               rmse_vs_golden=float(np.sqrt(np.mean((f - r) ** 2))),
               mean_rel_vs_golden=mean_rel, channels_off_5pct=off,
               launches=films["cuda"][1], retry_counts=films["cuda"][3],
               rays_card=films["cuda"][2], rays_cpu=films["cpu"][2],
               alpha_table_rows=int(scene.bwa_rows.shape[0]),
               alpha_table_depth=scene.bwa_depth, k2_alpha=k2_alpha)
    emit(out)
    return out, (scene.bwa_rows, scene.bwa_depth, o, d, t_inf, t_any)


def phase_sponza_main(dev, smi: str):
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    torch.cuda.reset_peak_memory_stats(dev)
    cam, scene, load_s, create_s = classroom_scene(dev, SPONZA_RES, SPONZA)
    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    integ = PathIntegrator(cfg, spp=SPONZA_SPP)
    _, n_bands = integ.band_layout(cam)
    expect = n_bands * integ.spp * (2 * cfg.max_depth + 1)

    t0 = time.perf_counter()
    integ.render(cam, scene)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    film, runs = timed_renders(integ, cam, scene, {k2: expect, k1: 0},
                               "Sponza")
    retry = runs["retry_counts_runs"][-1]
    band_frames = n_bands * integ.spp
    w, h = SPONZA_RES
    if tuple(film.shape) != (h, w, 4):
        raise AssertionError(f"film shape {tuple(film.shape)}")
    if not bool(torch.isfinite(film).all()):
        raise AssertionError("film has non-finite values")
    if not bool((film[..., 3] > 0).all()):
        raise AssertionError("film weight must be positive everywhere")
    if not retry["alpha_tree"] > 0:
        raise AssertionError("Sponza render never queried its alpha table")
    if not runs["texture_launches"]["texture_eval"] > 0:
        raise AssertionError("Sponza render never launched K3")
    peak = torch.cuda.max_memory_allocated(dev)
    table = scene.bw_rows
    f = int(scene.tri_pack.shape[0])
    out = dict(phase="sponza_main", resolution=list(SPONZA_RES),
               triangles=f, n_opaque=scene.n_opaque,
               masked=f - scene.n_opaque,
               textures=int(scene.data.tex.n_levels.shape[0]),
               pool_texels=int(scene.data.tex.data.shape[0]),
               table_rows=int(table.shape[0]),
               table_bytes=table.numel() * table.element_size(),
               depth=scene.bw_depth,
               alpha_table_rows=int(scene.bwa_rows.shape[0]),
               alpha_depth=scene.bwa_depth, spp=integ.spp,
               max_depth=cfg.max_depth, mis_mode=cfg.mis_mode,
               bands=n_bands, **runs, warmup_seconds=warm_s,
               load_seconds=load_s, create_seconds=create_s,
               launches=k2.LAUNCHES, expected_main_launches=expect,
               k2_launches_main=k2.LAUNCHES - retry["alpha_tree"],
               k2_launches_alpha=retry["alpha_tree"],
               k1_launches=k1.LAUNCHES,
               retry_syncs_per_band_frame=retry["syncs"] / band_frames,
               retry_passes_per_band_frame=retry["passes"] / band_frames,
               peak_mem_bytes=peak, bad_samples=integ.bad_sample_count,
               film_mean_rgb=[float(v) for v in
                              film[..., :3].mean(dim=(0, 1)).cpu()],
               card=smi)
    emit(out)
    return out, cam, scene


class CaptureDone(Exception):
    """Ends a render once ``capture_texture_inputs`` holds its inputs."""


def capture_texture_inputs(cam, scene, want: tuple) -> dict:
    """The arguments of a render's first K3 call in each mode of ``want``
    ("width": with UV derivatives, "static": without) and, with "cut", the
    hit records of its first K4 call: the main path's inputs at its shapes
    (a wave of the integrator's WAVE_LANES lanes). The render (depth 5,
    "onesample", 1 spp) stops once it has them. The fallback is kept as
    the view the call got (its strides are part of the input)."""
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import texture_cu as tx

    got = {}
    texture_eval, alpha_cut = tx.texture_eval, tx.alpha_cut

    def done():
        if set(want) <= set(got):
            raise CaptureDone

    def spy_texture(sd, txd_id, uv, fallback, duv=None, image=True):
        mode = "static" if duv is None else "width"
        if mode in want and mode not in got:
            got[mode] = (txd_id.clone(), uv.clone(), fallback,
                         None if duv is None else
                         tuple(x.clone() for x in duv), image)
            done()
        return texture_eval(sd, txd_id, uv, fallback, duv=duv, image=image)

    def spy_cut(ts, hit):
        if "cut" in want and "cut" not in got:
            got["cut"] = {k: v.clone() for k, v in hit.items()}
            done()
        return alpha_cut(ts, hit)

    tx.texture_eval, tx.alpha_cut = spy_texture, spy_cut
    try:
        with eager_band_frames():
            PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=1).render(cam, scene)
    except CaptureDone:
        pass
    finally:
        tx.texture_eval, tx.alpha_cut = texture_eval, alpha_cut
    torch.cuda.synchronize()
    if set(got) != set(want):
        raise AssertionError(f"the render made no K3 / K4 call of "
                             f"{set(want) - set(got)}")
    return got


class TexelLog:
    """A texture pool's ``data`` that logs the indices it is read at."""

    def __init__(self, data):
        self.data, self.reads = data, []

    def __getitem__(self, idx):
        self.reads.append(idx)
        return self.data[idx]


def texels_needed(sd, run, lanes) -> int:
    """The texels ``run(scene data)`` (a plain version) gathers for the
    lanes of ``lanes`` ((N,) bool), each counted once: what those lanes'
    lookups need."""
    import dataclasses

    import torch
    log = TexelLog(sd.tex.data)
    run(dataclasses.replace(sd, tex=dataclasses.replace(sd.tex, data=log)))
    idx = [i[lanes] for i in log.reads]
    return int(torch.unique(torch.cat(idx)).numel()) if idx else 0


def bits_diff(pairs) -> dict:
    """How far ``(got, want)`` f32 tensor pairs are from equal bits: the
    words that differ, the largest distance in ulps (both as int32 bit
    patterns) and the largest absolute difference."""
    import torch
    words, ulps = 0, 0
    for got, want in pairs:
        g, w = got.view(torch.int32).long(), want.view(torch.int32).long()
        bad = g != w
        words += int(bad.sum())
        if bad.any():
            ulps = max(ulps, int((g - w)[bad].abs().max()))
    return dict(words_differing=words, max_ulps=ulps,
                max_abs_err=max_abs_err(pairs))


def texture_case(sd, inputs) -> dict:
    """K3 against its plain version on one captured call (bits equal, or
    the differences reported and raised), timed, with its bound: each
    lane's id, uv, derivatives (width mode) and output, the fallback rows
    of the lanes that take it, the packed rows of the descriptors used,
    the texels the image lanes need, and the FP32 operations of each
    lane's arm."""
    import torch

    from pathtracer_tpu_torch.ops import bsdf
    from pathtracer_tpu_torch.ops.cuda import texture_cu as tx
    from pathtracer_tpu_torch.scene.texture import TXF_WIDTH, TXI_WIDTH

    txd, uv, fallback, duv, image = inputs
    n = txd.shape[0]

    def kernel():
        return tx.texture_eval(sd, txd, uv, fallback, duv=duv, image=image)

    def plain(scene=sd):
        return bsdf.eval_texture_plain(scene, txd, uv, fallback, duv=duv,
                                       image=image)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    safe = torch.clamp_min(txd, 0).long()
    image_lanes = (txd >= 0) & (sd.txd_kind[safe] == 2) & bool(image)
    out = dict(lanes=n, mode="static" if duv is None else "width",
               image_lanes=int(image_lanes.sum()),
               fallback_lanes=int((txd < 0).sum()),
               srgb_lanes=int((image_lanes & sd.txd_srgb[safe]).sum()),
               fallback_strides=list(fallback.stride()),
               **bits_diff([(got, want)]))
    if out["words_differing"]:
        bad = (got.view(torch.int32) != want.view(torch.int32)).any(-1)
        out["differing_lanes"] = dict(
            image=int((bad & image_lanes).sum()),
            srgb=int((bad & image_lanes & sd.txd_srgb[safe]).sum()),
            checker=int((bad & (sd.txd_kind[safe] == 1)).sum()))
        emit(dict(phase="texture_kernels_mismatch", kernel="K3", **out))
        raise AssertionError(f"K3 differs from its plain version: {out}")
    texels = texels_needed(sd, plain, image_lanes)
    descs = int(torch.unique(txd[txd >= 0]).numel())
    nbytes = (24.0 * n + (16.0 * n if duv is not None else 0.0)
              + 12.0 * out["fallback_lanes"]
              + 4.0 * descs * (TXF_WIDTH + TXI_WIDTH) + 12.0 * texels)
    ops = TEX_UV_OPS * n + out["image_lanes"] * (
        TEX_IMAGE_OPS + (TEX_LEVEL_OPS if duv is None
                         else 2 * TEX_LEVEL_OPS + TEX_WIDTH_OPS))
    out.update(texels_needed=texels, descriptors=descs,
               **timings(kernel, plain, plain_calls=PLAIN_TEX_CALLS,
                         plain_reps=PLAIN_TEX_CALLS),
               **bound(nbytes, ops))
    return out


def cut_case(ts, hit) -> dict:
    """K4 against its plain version on one set of hit records (cut equal,
    p_hit, p_err and ng equal bits, or the differences reported and
    raised), timed, with its bound: each lane's tri id, barycentrics and
    valid flag in and its 37 B out, the 19 floats of each tri_attr row
    the lanes use (P0-P2, NG0, UV0-UV2, ALPHA), the packed rows of the
    mask descriptors, the texels the masked hits need, and the FP32
    operations of each lane."""
    import types

    import torch

    from pathtracer_tpu_torch import integrator as pint
    from pathtracer_tpu_torch.ops.cuda import texture_cu as tx
    from pathtracer_tpu_torch.scene.scene import TA_ALPHA
    from pathtracer_tpu_torch.scene.texture import TXF_WIDTH, TXI_WIDTH

    sd = ts.data
    n = hit["tri"].shape[0]

    def kernel():
        return tx.alpha_cut(ts, hit)

    def plain(scene=ts):
        return pint._alpha_cut_plain(scene, hit)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    txd = ts.tri_attr[hit["tri"].long()][:, TA_ALPHA].to(torch.int32)
    tested = hit["valid"] & (txd >= 0)
    image_lanes = tested & (sd.txd_kind[torch.clamp_min(txd, 0).long()]
                            == 2)
    out = dict(lanes=n, valid=int(hit["valid"].sum()),
               tested=int(tested.sum()), image_lanes=int(image_lanes.sum()),
               cut=int(got[0].sum()), cut_equal=bool(torch.equal(got[0],
                                                                 want[0])),
               **bits_diff(list(zip(got[1:], want[1:]))))
    if not out["cut_equal"] or out["words_differing"]:
        out["cut_differing"] = int((got[0] != want[0]).sum())
        emit(dict(phase="texture_kernels_mismatch", kernel="K4", **out))
        raise AssertionError(f"K4 differs from its plain version: {out}")
    texels = texels_needed(sd, lambda s: plain(types.SimpleNamespace(
        tri_attr=ts.tri_attr, data=s)), image_lanes)
    rows = int(torch.unique(hit["tri"]).numel())
    descs = int(torch.unique(txd[tested]).numel())
    nbytes = (17.0 * n + 37.0 * n + 76.0 * rows
              + 4.0 * descs * (TXF_WIDTH + TXI_WIDTH) + 12.0 * texels)
    ops = CUT_OPS * n + (CUT_UV_OPS + TEX_UV_OPS) * out["tested"] \
        + (TEX_LEVEL_OPS + TEX_IMAGE_OPS) * out["image_lanes"]
    out.update(texels_needed=texels, rows=rows, descriptors=descs,
               **timings(kernel, plain, plain_calls=PLAIN_TEX_CALLS,
                         plain_reps=PLAIN_TEX_CALLS),
               **bound(nbytes, ops))
    return out


def phase_texture_kernels(dev, class_cam, class_scene, sponza_cam,
                          sponza_scene, alpha_set):
    """K3 and K4 against their plain versions at the main path's shapes:
    K3 on the first calls of a classroom and a Sponza render in both
    modes (with and without UV derivatives), K4 on the first
    ``_alpha_cut`` call of a Sponza render and on phase 16's foliage
    rays through Sponza's alpha table (K2, closest). Returns the phase's
    figures and, for the profile phase, a call of each case."""
    from pathtracer_tpu_torch import integrator as pint
    from pathtracer_tpu_torch.ops.cuda import texture_cu as tx

    t0 = time.perf_counter()
    inputs = {"classroom": capture_texture_inputs(
        class_cam, class_scene, ("width", "static")),
        "sponza": capture_texture_inputs(sponza_cam, sponza_scene,
                                         ("width", "static", "cut"))}
    _, _, o, d, t_inf, _ = alpha_set
    foliage = pint._alpha_tree_isect(sponza_scene, o, d, t_inf)
    cases, calls = {}, {}
    for name, ts in (("classroom", class_scene), ("sponza", sponza_scene)):
        for mode in ("width", "static"):
            args = inputs[name][mode]
            cases[f"{name}_{mode}"] = texture_case(ts.data, args)
            calls[f"{name}_{mode}"] = (
                "texture_eval_kernel",
                lambda sd=ts.data, a=args: tx.texture_eval(
                    sd, *a[:3], duv=a[3], image=a[4]))
    for name, hit in (("sponza_render", inputs["sponza"]["cut"]),
                      ("sponza_foliage", foliage)):
        cases[f"cut_{name}"] = cut_case(sponza_scene, hit)
        calls[f"cut_{name}"] = (
            "alpha_cut_kernel",
            lambda h=hit: tx.alpha_cut(sponza_scene, h))
    out = dict(phase="texture_kernels", cases=cases,
               seconds=time.perf_counter() - t0)
    emit(out)
    return out, calls


# bytes a lane of each material reads for its own model in K5 (eval) and
# K6 (sample), beside the type (4 B) and the lane's common inputs and
# outputs (BSDF_LANE_BYTES): kd / ks / eta3 / k rows 12 B each, eta, ax,
# ay, metallic 4 B each (csrc/bsdf.cu)
BSDF_MODEL_BYTES = {
    "eval": {0: 12, 1: 0, 2: 0, 3: 44, 4: 32, 5: 28, 6: 24},
    "sample": {0: 12, 1: 0, 2: 16, 3: 44, 4: 32, 5: 28, 6: 24}}
# the frame (48 B) and the type (4 B), then K5's wo, wi (24 B) and f, pdf,
# cosine (20 B); K6's wo, u (20 B) and wi, f, pdf, cosine, two flags
# (34 B)
BSDF_LANE_BYTES = {"eval": 52 + 24 + 20, "sample": 52 + 20 + 34}
BSDF_RES = (640, 480)
SPHERES = os.path.join(ROOT, "benchmark", "scenes", "cornell-spheres.xml")


def capture_bsdf_inputs(cam, scene, depth: int) -> dict:
    """The arguments of a render's first K5 and K6 calls (mp, it, wo, wi
    or u, present), on the eager path (``eager_band_frames``, so the spy
    may stop the render): the main path's inputs at its shapes."""
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bsdf_cu

    got = {}
    calls = dict(eval=bsdf_cu.bsdf_eval, sample=bsdf_cu.bsdf_sample)

    def spy(kind):
        def call(mp, it, wo, x, present):
            got.setdefault(kind, (mp, it, wo, x, present))
            if len(got) == 2:
                raise CaptureDone
            return calls[kind](mp, it, wo, x, present=present)
        return call

    bsdf_cu.bsdf_eval, bsdf_cu.bsdf_sample = spy("eval"), spy("sample")
    try:
        with eager_band_frames():
            PathIntegrator(PathConfig(max_depth=depth, mis_mode="onesample"),
                           spp=1).render(cam, scene)
    except CaptureDone:
        pass
    finally:
        bsdf_cu.bsdf_eval, bsdf_cu.bsdf_sample = calls["eval"], \
            calls["sample"]
    torch.cuda.synchronize()
    if len(got) != 2:
        raise AssertionError(f"the render made no K5 / K6 call: {set(got)}")
    return got


def bsdf_case(kind: str, args) -> dict:
    """K5 or K6 against its plain version on one captured call (every
    output ``torch.equal``, or the elements that differ reported and
    raised), timed (the device time in ``phase_profile``),
    with its bound: the bytes of ``BSDF_LANE_BYTES`` and
    ``BSDF_MODEL_BYTES`` of each lane."""
    import torch

    from pathtracer_tpu_torch.ops import bsdf
    from pathtracer_tpu_torch.ops.cuda import bsdf_cu

    mp, it, wo, x, present = args
    kernel = dict(eval=bsdf_cu.bsdf_eval, sample=bsdf_cu.bsdf_sample)[kind]
    plain = dict(eval=bsdf.eval_world, sample=bsdf.sample_world)[kind]

    def flat(out):
        return list(out.values()) if isinstance(out, dict) else list(out)

    got = flat(kernel(mp, it, wo, x, present=present))
    want = flat(plain(mp, it, wo, x, present=present))
    torch.cuda.synchronize()
    mtype = mp["mtype"]
    first = min(present)
    per_type = {int(t): int((mtype == t).sum()) for t in range(7)}
    model = sum(n * BSDF_MODEL_BYTES[kind][t if t in present else first]
                for t, n in per_type.items())
    n = mtype.shape[0]
    out = dict(lanes=n, present=list(present), lanes_by_type=per_type,
               differing=[int((g != w).sum()) for g, w in zip(got, want)])
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        emit(dict(phase="bsdf_kernels_mismatch", kernel=kind, **out))
        raise AssertionError(f"K5 / K6 {kind} differs from its plain "
                             f"version: {out}")
    out.update(timings(lambda: kernel(mp, it, wo, x, present=present),
                       plain=lambda: plain(mp, it, wo, x, present=present)))
    out.update(bound(BSDF_LANE_BYTES[kind] * n + model, 0.0))
    return out


def phase_bsdf_kernels(dev):
    """K5 and K6 against their plain versions at the main path's shapes,
    on the first calls of a cornell-spheres render (depth 15) and of a
    cornell render (depth 5). Returns the phase's figures and, for the
    profile phase, a call of each case."""
    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.ops.cuda import bsdf_cu
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    t0 = time.perf_counter()
    cases, calls = {}, {}
    kernels = dict(eval=bsdf_cu.bsdf_eval, sample=bsdf_cu.bsdf_sample)
    for name, path, depth in (("spheres", SPHERES, 15),
                              ("cornell", CORNELL, 5)):
        cam, sd, _ = load_mitsuba(path, resolution=BSDF_RES, device=dev)
        scene = TracedScene.create(sd)
        args = capture_bsdf_inputs(cam, scene, depth)
        for kind in ("eval", "sample"):
            cases[f"{name}_{kind}"] = bsdf_case(kind, args[kind])
            calls[f"{name}_{kind}"] = (
                f"bsdf_{kind}_kernel",
                lambda f=kernels[kind], a=args[kind]: f(*a[:4],
                                                        present=a[4]))
    out = dict(phase="bsdf_kernels", cases=cases,
               seconds=time.perf_counter() - t0)
    emit(out)
    return out, calls


# bytes a K7 lane must move (csrc/sobol.cu): the index reads b_base (8 B)
# and writes the (lo, hi) words (16 B); a draw reads the index words (16
# B) and its scramble (8 B; the camera's unscrambled pair none) and writes
# 4 B a dimension
SOBOL_LANE_BYTES = dict(index=8 + 16, dim=16 + 8 + 4, dim2=16 + 8 + 8,
                        camera=16 + 8)
# the spheres' depth: its draws reach dimension 2 + 8 * 14 + 7
SOBOL_DEPTH = 15


def phase_sobol_kernels(dev):
    """K7 against the plain chain of ``ops/sobol.py`` at the main path's
    shapes: the 130,732 lanes of a 640 x 480 render's first band (b_base,
    scramble) at its frame 3 and at frame 4101 (the shifted high word
    set). The index and every draw a depth-15 band-frame makes
    ``torch.equal``; the index, a 1-D and a 2-D scrambled draw and the
    camera's unscrambled pair timed beside the plain chain, with their
    byte bounds (K7's launches are checked in each main path's renders,
    ``timed_renders``). Returns the phase's figures and, for the profile
    phase, a call of each case and of its plain chain."""
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops import sobol as sb
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.ops.cuda import sobol_cu as k7
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    t0 = time.perf_counter()
    cam, sd, _ = load_mitsuba(CORNELL, resolution=BSDF_RES, device=dev)
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=4)
    su = integ.setup(cam, sd)
    band = integ.band(su, su.y0, integ.band_layout(cam)[0], su.y1)
    b_base, scr, sm32 = band.b_base, band.scramble, su.sobol_pack
    n = b_base.shape[0]
    inv = (su.inv_lo, su.inv_hi)
    mismatches = []
    for frame in (3, 4101):
        lo_w, hi_w, delta = (int(w) for w in sb.frame_statics(su.domain,
                                                              frame))
        got = k7.sobol_index(b_base, delta, lo_w, hi_w, *inv)
        idx = sb.sobol_index(b_base, delta, lo_w, hi_w, *inv)
        if not all(torch.equal(g, w) for g, w in zip(got, idx)):
            mismatches.append(dict(frame=frame, what="index"))
        for dim in range(2 + 8 * SOBOL_DEPTH):
            for kernel, plain in ((k7.sobol_sample_dim, sb.sobol_sample_dim),
                                  (k7.sobol_sample_dim2,
                                   sb.sobol_sample_dim2)):
                for s in (scr, None):
                    got = kernel(*idx, dim, s, sm32)
                    want = plain(*idx, dim, torch.zeros_like(scr)
                                 if s is None else s, sm32)
                    if not torch.equal(got, want):
                        mismatches.append(dict(
                            frame=frame, dim=dim, what=plain.__name__,
                            scrambled=s is not None,
                            differing=int((got != want).sum())))
    torch.cuda.synchronize()
    if mismatches:
        emit(dict(phase="sobol_kernels_mismatch", cases=mismatches[:20]))
        raise AssertionError(f"K7 differs from the plain chain in "
                             f"{len(mismatches)} cases")
    lo_w, hi_w, delta = (int(w) for w in sb.frame_statics(su.domain, 3))
    idx = sb.sobol_index(b_base, delta, lo_w, hi_w, *inv)
    pairs = dict(
        index=(lambda: k7.sobol_index(b_base, delta, lo_w, hi_w, *inv),
               lambda: sb.sobol_index(b_base, delta, lo_w, hi_w, *inv),
               "sobol_index_kernel"),
        dim=(lambda: k7.sobol_sample_dim(*idx, 7, scr, sm32),
             lambda: sb.sobol_sample_dim(*idx, 7, scr, sm32),
             "sobol_draw_kernel"),
        dim2=(lambda: k7.sobol_sample_dim2(*idx, 5, scr, sm32),
              lambda: sb.sobol_sample_dim2(*idx, 5, scr, sm32),
              "sobol_draw_kernel"),
        camera=(lambda: k7.sobol_sample_dim2(*idx, 0, None, sm32),
                lambda: sb.sobol_sample_dim2(*idx, 0, torch.zeros_like(scr),
                                             sm32),
                "sobol_draw_kernel"))
    cases, calls = {}, {}
    for case, (kernel, plain, name) in pairs.items():
        cases[case] = dict(lanes=n, **timings(kernel, plain=plain),
                           **bound(SOBOL_LANE_BYTES[case] * n, 0.0))
        calls[case] = (name, kernel)
        calls[f"plain_{case}"] = (None, plain)
    out = dict(phase="sobol_kernels", cases=cases,
               ptxas=_build.ptxas_report(k7.build()),
               seconds=time.perf_counter() - t0)
    emit(out)
    return out, calls


# bytes a K8 lane must move (csrc/env.cu): env_eval reads its direction
# (12 B) and writes Le (12 B), the pdf (4 B) or both; env_sample reads u
# (8 B) and writes wi, the pdf and Le (28 B). The map and the tables are
# the lanes' shared inputs, which the bounce loop leaves in L2: not counted
ENV_LANE_BYTES = dict(le=12 + 12, pdf=12 + 4, le_pdf=12 + 16, sample=8 + 28)
TANKFARM = os.path.join(ROOT, "benchmark", "scenes", "tankfarm-spheres.xml")
# the cell's depth, and the band-frame whose calls the phase takes (the
# fourth a render runs: band 0's frame 3)
ENV_DEPTH = 15
ENV_FRAME = 3


def capture_env_inputs(cam, scene, depth: int, frame: int) -> dict:
    """The arguments of K8's calls in band-frame ``frame`` of a render
    (one-sample MIS at ``depth``, 4 spp) on the eager path
    (``eager_band_frames``, so the spy may stop the render): {"eval":
    [(sd, d, le, pdf) a call, one a bounce], "sample": [(sd, u) a call,
    one a shading bounce]}, the main path's inputs at its shapes."""
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import env_cu

    real_eval, real_sample = env_cu.env_eval, env_cu.env_sample
    evals, samples = [], []

    def spy_eval(sd, d, le=True, pdf=False):
        evals.append((sd, d, le, pdf))
        if len(evals) == (depth + 1) * (frame + 1):  # the frame's last
            raise CaptureDone
        return real_eval(sd, d, le=le, pdf=pdf)

    def spy_sample(sd, u):
        samples.append((sd, u))
        return real_sample(sd, u)

    env_cu.env_eval, env_cu.env_sample = spy_eval, spy_sample
    try:
        with eager_band_frames():
            PathIntegrator(PathConfig(max_depth=depth, mis_mode="onesample"),
                           spp=4).render(cam, scene)
    except CaptureDone:
        pass
    finally:
        env_cu.env_eval, env_cu.env_sample = real_eval, real_sample
    torch.cuda.synchronize()
    if len(evals) != (depth + 1) * (frame + 1) or \
            len(samples) != depth * (frame + 1):
        raise AssertionError(f"the render made {len(evals)} env_eval and "
                             f"{len(samples)} env_sample calls")
    return dict(eval=evals[-(depth + 1):], sample=samples[-depth:])


def env_render_launches(dev, path: str, depth: int) -> dict:
    """K8's launches in a 640 x 480 4-spp render of the scene at
    ``path`` (one-sample MIS at ``depth``, the graph path after a warm-up
    render) against ``env_launches``, and a band-frame's share."""
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.ops.cuda import env_cu
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(path, resolution=BSDF_RES, device=dev)
    scene = TracedScene.create(sd)
    integ = PathIntegrator(PathConfig(max_depth=depth, mis_mode="onesample"),
                           spp=4)
    integ.render(cam, scene)
    for key in env_cu.LAUNCHES:
        env_cu.LAUNCHES[key] = 0
    integ.render(cam, scene)
    got, want = dict(env_cu.LAUNCHES), env_launches(integ, cam, scene)
    if got != want:
        raise AssertionError(f"{path} render launched K8 {got}, expected "
                             f"{want}")
    frames = integ.band_layout(cam)[1] * integ.spp
    return dict(launches=got, band_frames=frames,
                per_band_frame={k: v / frames for k, v in got.items()})


def phase_env_kernels(dev):
    """K8 against its plain twins (``lights.env_eval_plain`` /
    ``env_sample_plain``) at the cell's shapes: the tank farm's map and
    tables, the 130,732 lanes of a 640 x 480 render's first band at its
    frame 3, on the arguments of every K8 call of that band-frame (taken
    by a spy on the eager path): each direction with radiance, pdf and
    both, each u, ``torch.equal``. Then timed: the camera rays' radiance
    (bounce 0), bounce 1's radiance and pdf and its pdf alone, bounce 0's
    light sample: per call over back-to-back calls, one call, host us,
    device time (profiler), the plain twin's time and device time, and
    the byte bound. Last, K8's launches in a tank-farm render (16
    ``env_eval`` + 15 ``env_sample`` a band-frame) and a cornell one
    (none), held to ``env_launches``."""
    import torch

    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.ops import lights as lt
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.ops.cuda import env_cu as k8
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    t0 = time.perf_counter()
    cam, sd, _ = load_mitsuba(TANKFARM, resolution=BSDF_RES, device=dev)
    got = capture_env_inputs(cam, TracedScene.create(sd), ENV_DEPTH,
                             ENV_FRAME)
    mismatches = []
    for bounce, (sd_, d, _, _) in enumerate(got["eval"]):
        for le, pdf in ((True, False), (False, True), (True, True)):
            outs = zip(("le", "pdf"), k8.env_eval(sd_, d, le=le, pdf=pdf),
                       lt.env_eval_plain(sd_, d, le=le, pdf=pdf))
            for name, g, w in outs:
                if g is not None and not torch.equal(g, w):
                    mismatches.append(dict(
                        bounce=bounce, call=(le, pdf), what=name,
                        differing=int((g != w).any(-1).sum() if g.dim() > 1
                                      else (g != w).sum())))
    for bounce, (sd_, u) in enumerate(got["sample"]):
        outs = zip(("wi", "pdf", "le"), k8.env_sample(sd_, u),
                   lt.env_sample_plain(sd_, u))
        for name, g, w in outs:
            if not torch.equal(g, w):
                mismatches.append(dict(bounce=bounce, call="sample",
                                       what=name))
    torch.cuda.synchronize()
    if mismatches:
        emit(dict(phase="env_kernels_mismatch", cases=mismatches[:20]))
        raise AssertionError(f"K8 differs from its plain twins in "
                             f"{len(mismatches)} cases")
    d0, d1 = got["eval"][0][1], got["eval"][1][1]
    u0 = got["sample"][0][1]
    n = d0.shape[0]
    pairs = dict(
        le=(lambda: k8.env_eval(sd, d0),
            lambda: lt.env_eval_plain(sd, d0), "env_eval_kernel"),
        pdf=(lambda: k8.env_eval(sd, d1, le=False, pdf=True),
             lambda: lt.env_eval_plain(sd, d1, le=False, pdf=True),
             "env_eval_kernel"),
        le_pdf=(lambda: k8.env_eval(sd, d1, pdf=True),
                lambda: lt.env_eval_plain(sd, d1, pdf=True),
                "env_eval_kernel"),
        sample=(lambda: k8.env_sample(sd, u0),
                lambda: lt.env_sample_plain(sd, u0), "env_sample_kernel"))
    cases = {}
    for case, (kernel, plain, name) in pairs.items():
        cases[case] = dict(lanes=n, **timings(kernel, plain=plain),
                           device_ms=kernel_device_ms(kernel, name),
                           plain_device_ms=kernel_device_ms(plain),
                           **bound(ENV_LANE_BYTES[case] * n, 0.0))
    out = dict(phase="env_kernels", cases=cases,
               map=list(sd.env_map.shape), tables=list(
                   sd.env_cond_cdf.shape),
               tankfarm=env_render_launches(dev, TANKFARM, ENV_DEPTH),
               cornell=env_render_launches(dev, CORNELL, 5),
               ptxas=_build.ptxas_report(k8.build()),
               seconds=time.perf_counter() - t0)
    emit(out)
    return out


def phase_sponza_profile(cam, scene):
    """One Sponza render of phase 17 under torch.profiler, host and
    device (``render_profile``): the busy share, K2's share, device events
    a band-frame, and what the ``pt::alpha_cut`` spans launch: one K4 kernel
    each (its device time and share) and no kernel of a torch op (the
    plain lookup is gone from the range); K3's device time and share. It
    runs after phase 13: its trace is the largest, and the traces phase
    13 takes after one this large held no device time."""
    out = dict(phase="sponza_profile",
               **render_profile(cam, scene, SPONZA_SPP, "bvhw_kernel",
                                annotation="pt::alpha_cut", warmup=False,
                                kernels=("alpha_cut_kernel",
                                         "texture_eval_kernel")))
    k4 = out["by_kernel"]["alpha_cut_kernel"]
    if k4["launches"] != out["annotation_ranges"] or \
            out["annotated_launches"] != 0:
        raise AssertionError(
            f"Sponza's alpha_cut ranges ({out['annotation_ranges']}) "
            f"launched {k4['launches']} K4 kernels and "
            f"{out['annotated_launches']} kernels of torch ops")
    emit(out)
    return out


def alpha_sheets(dev, nx: int, nz: int, sheets: int, floor: bool,
                 seed: int = 7):
    """A synthetic alpha scene on ``dev``: ``sheets`` stacked sheets (y =
    1, 1.55, ...) of nx x nz masked unit quads (2 triangles each) over an
    optional floor, under a point light. The mask (8x8, numpy ``seed``)
    has half its texels 0 and the rest in [0.2, 1)."""
    import numpy as np

    from pathtracer_tpu_torch.scene.scene import MAT_MATTE, SceneBuilder

    rng = np.random.default_rng(seed)
    alpha = np.where(rng.random((8, 8)) < 0.5, 0.0,
                     rng.uniform(0.2, 1.0, (8, 8))).astype(np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]])
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    b = SceneBuilder()
    floor_m = b.add_material(mtype=MAT_MATTE, kd=(0.8, 0.8, 0.8))
    leaf_m = b.add_material(mtype=MAT_MATTE, kd=(0.2, 0.8, 0.2))
    a_txd = b.add_texture_image(np.repeat(alpha[..., None], 3, -1))
    if floor:
        b.add_mesh(np.array([[-12, 0, -12], [12, 0, -12], [12, 0, 12],
                             [-12, 0, 12]], np.float32), idx, None, uv,
                   floor_m)
    for gy in range(sheets):
        y = 1.0 + 0.55 * gy
        for i in range(nx):
            for j in range(nz):
                cx, cz = -nx / 2 + i + 0.3 * gy, -nz / 2 + j + 0.2 * gy
                b.add_mesh(np.array([[cx, y, cz], [cx + 1, y, cz],
                                     [cx + 1, y, cz + 1], [cx, y, cz + 1]],
                                    np.float32), idx, None, uv, leaf_m,
                           alpha_txd=a_txd)
    b.add_point_light((0.0, 4.0, 0.0), (60.0, 60.0, 60.0))
    return b.build(device=dev)


def sheet_rays(n: int, extent: float, dev, seed: int = 3):
    """Rays down through the sheets from y = 3 (tilted), and shadow
    feelers from the floor up to the light. Returns (o, d, t_inf, o2, d2,
    t2) on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-extent, extent, n), np.full(n, 3.0),
                  rng.uniform(-extent, extent, n)], -1)
    d = np.stack([rng.normal(0, 0.15, n), -np.ones(n),
                  rng.normal(0, 0.15, n)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o2 = np.stack([rng.uniform(-extent, extent, n), np.full(n, 0.01),
                   rng.uniform(-extent, extent, n)], -1)
    d2 = np.array([0.0, 4.0, 0.0]) - o2
    t2 = np.linalg.norm(d2, axis=-1) * 0.999
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (t(o), t(d), torch.full((n,), torch.inf, device=dev), t(o2),
            t(d2), t(t2))


def peak_call(fn):
    """(result, peak device bytes above what was allocated before) of one
    synchronised call of ``fn``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def held_to_cpu(card, cpu, what: str) -> dict:
    """A card hit record (or occlusion) against the CPU's on the CPU's
    lanes (the first ones): valid, tri and occlusion equal, t and b within
    rtol 1e-5 / atol 1e-6. Returns the largest differences."""
    import torch

    if isinstance(cpu, torch.Tensor):
        if not torch.equal(card[:cpu.shape[0]].cpu(), cpu):
            raise AssertionError(f"{what}: occlusion differs card vs CPU")
        return dict(lanes=cpu.shape[0], occluded=int(cpu.sum()))
    n = cpu["valid"].shape[0]
    got = {k: v[:n].cpu() for k, v in card.items()}
    for key in ("valid", "tri"):
        if not torch.equal(got[key], cpu[key]):
            raise AssertionError(f"{what}: {key} differs card vs CPU")
    for key in ("t", "b"):
        torch.testing.assert_close(got[key], cpu[key], rtol=1e-5, atol=1e-6)
    return dict(lanes=n, hits=int(cpu["valid"].sum()),
                max_abs_err=max_abs_err([(got["t"], cpu["t"]),
                                         (got["b"], cpu["b"])]))


def phase_alpha_routes(dev):
    """The alpha routes Sponza does not take, at a whole wave's 131,072
    lanes: the dense pass (512 masked triangles: the split route's subset
    below its own table), the binary tree of an all-masked scene against
    the dense pass on the same rays, and the brute-force route (K1 with
    re-spawn retries), each held to the CPU on its first 16,384 lanes."""
    import torch

    from pathtracer_tpu_torch import integrator as pint
    from pathtracer_tpu_torch.accel.bvh import _alpha_test_inline
    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.ops.intersect import intersect_alpha_dense

    cpu = torch.device("cpu")
    n, nc = ALPHA_RAYS, ALPHA_CPU_RAYS
    rays = {dev: sheet_rays(n, 9.0, dev)}
    rays[cpu] = tuple(x[:nc].cpu().contiguous() for x in rays[dev])
    out = dict(phase="alpha_routes", lanes=n, cpu_lanes=nc)

    # the dense pass: 512 masked triangles over a floor
    scenes = {where: TracedScene.create(alpha_sheets(where, 16, 16, 1, True))
              for where in (dev, cpu)}
    if not (scenes[dev].split_alpha and scenes[dev].bwa_rows is None
            and scenes[dev].n_opaque == 2):
        raise AssertionError("512 masked triangles must take the dense pass")

    def dense(where, any_hit=False):
        o, d, t_inf, o2, d2, t2 = rays[where]
        if any_hit:
            return pint._alpha_set_intersect(scenes[where], o2, d2, t2,
                                             any_hit=True)
        return pint._alpha_set_intersect(scenes[where], o, d, t_inf)

    hit, peak = peak_call(lambda: dense(dev))
    occ, peak_any = peak_call(lambda: dense(dev, True))
    out["dense"] = dict(
        masked=512, ms=time_ms(lambda: dense(dev), reps=ALPHA_ROUTE_REPS),
        ms_anyhit=time_ms(lambda: dense(dev, True), reps=ALPHA_ROUTE_REPS),
        peak_bytes=peak, peak_bytes_anyhit=peak_any,
        closest=held_to_cpu(hit, dense(cpu), "dense closest"),
        anyhit=held_to_cpu(occ, dense(cpu, True), "dense any hit"))

    # the binary tree of an all-masked scene (1,024 triangles in two
    # sheets) against the dense pass over the same triangles
    scene = TracedScene.create(alpha_sheets(dev, 16, 16, 2, False),
                               use_bvh=True)
    if scene.bvh_nodes is None or scene.bw_rows is not None:
        raise AssertionError("an all-masked scene must keep its binary tree")
    o, d, t_inf, o2, d2, t2 = rays[dev]
    sd = scene.data

    def all_dense(o_, d_, t_, any_hit=False):
        return intersect_alpha_dense(
            o_, d_, t_, sd.p0, sd.p1, sd.p2, 0,
            lambda pid, b: _alpha_test_inline(scene.alpha_pack,
                                              scene.alpha_texels, pid, b),
            any_hit=any_hit)

    tree = pint._scene_intersect(scene, o, d, t_inf)
    flat = all_dense(o, d, t_inf)
    if not torch.equal(tree["valid"], flat["valid"]):
        raise AssertionError("binary tree and dense pass: valid differs")
    hit = tree["valid"]
    if not torch.equal(tree["t"][hit], flat["t"][hit]):
        raise AssertionError("binary tree and dense pass: t differs")
    ties = hit & (tree["tri"] != flat["tri"])
    occ_tree = pint._scene_intersect_p(scene, o2, d2, t2)
    if not torch.equal(occ_tree, all_dense(o2, d2, t2, True)):
        raise AssertionError("binary tree and dense pass: occlusion differs")
    scene_cpu = TracedScene.create(alpha_sheets(cpu, 16, 16, 2, False),
                                   use_bvh=True)
    oc, dc, tc, o2c, d2c, t2c = rays[cpu]
    out["binary"] = dict(
        masked=int(sd.p0.shape[0]), nodes=int(scene.bvh_nodes.shape[0]),
        ms=time_ms(lambda: pint._scene_intersect(scene, o, d, t_inf),
                   reps=ALPHA_ROUTE_REPS),
        ms_anyhit=time_ms(lambda: pint._scene_intersect_p(scene, o2, d2, t2),
                          reps=ALPHA_ROUTE_REPS),
        dense_ms=time_ms(lambda: all_dense(o, d, t_inf),
                         reps=ALPHA_ROUTE_REPS),
        dense_ms_anyhit=time_ms(lambda: all_dense(o2, d2, t2, True),
                                reps=ALPHA_ROUTE_REPS),
        hits=int(hit.sum()), tri_ties=int(ties.sum()),
        closest=held_to_cpu(tree, pint._scene_intersect(scene_cpu, oc, dc,
                                                        tc), "binary"),
        anyhit=held_to_cpu(occ_tree, pint._scene_intersect_p(
            scene_cpu, o2c, d2c, t2c), "binary any hit"))

    # the brute-force route: K1 and re-spawn retries, 258 triangles
    scenes = {where: TracedScene.create(alpha_sheets(where, 8, 8, 2, True),
                                        use_bvh=False)
              for where in (dev, cpu)}

    def brute(where):
        o, d, t_inf, o2, d2, t2 = rays[where]
        return (pint._scene_intersect(scenes[where], o, d, t_inf),
                pint._scene_intersect_p(scenes[where], o2, d2, t2))

    k1.LAUNCHES = 0  # the brute-force route's run starts here
    for key in pint.RETRY_COUNTS:
        pint.RETRY_COUNTS[key] = 0
    hit, occ = brute(dev)
    torch.cuda.synchronize()
    launches, passes = k1.LAUNCHES, pint.RETRY_COUNTS["passes"]
    if launches != 2 + passes or passes == 0:
        raise AssertionError(f"brute-force alpha route launched K1 "
                             f"{launches} times for {passes} re-spawn "
                             f"passes, expected {passes} + 2 (and some)")
    hit_cpu, occ_cpu = brute(cpu)
    out["brute"] = dict(
        triangles=int(scenes[dev].tri_pack.shape[0]), k1_launches=launches,
        retry_passes=passes,
        ms=time_ms(lambda: brute(dev), reps=ALPHA_ROUTE_REPS),
        closest=held_to_cpu(hit, hit_cpu, "brute"),
        anyhit=held_to_cpu(occ, occ_cpu, "brute any hit"))
    emit(out)
    return out


def card_vs_cpu(films: dict, what: str) -> dict:
    """The card's film against the CPU's at the goldens' bar: finite with
    positive weight, alpha rtol 1e-5, RGB RMSE < 1e-3."""
    import numpy as np

    got, want = films["cuda"], films["cpu"]
    if not (np.isfinite(got).all() and (got[..., 3] > 0).all()):
        raise AssertionError(f"{what}: card film must be finite with "
                             "positive weight")
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = float(np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2)))
    if not rmse < 1e-3:
        raise AssertionError(f"{what}: card vs CPU RMSE {rmse} >= 1e-3")
    diff = np.abs(got[..., :3] - want[..., :3]).max(axis=-1)
    return dict(rmse=rmse, pixels_differing=int((diff > 0).sum()),
                max_pixel_diff=float(diff.max()),
                film_mean_rgb=[float(v) for v in got[..., :3].mean((0, 1))])


def render_both(dev, make, cfg, spp: int, expect_card: tuple, what: str):
    """Render ``make(device) -> (camera, scene)`` on the CPU and on the
    card with ``PathIntegrator(cfg, spp)``; the card's (K1, K2) launches
    must be ``expect_card(integ, camera)``, the CPU's none. Returns
    ({device type: film}, card launches, {device type: ray count})."""
    import torch

    from pathtracer_tpu_torch.integrator import PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    films, rays, card = {}, {}, None
    for where in (torch.device("cpu"), dev):
        cam, scene = make(where)
        integ = PathIntegrator(cfg, spp=spp)
        before = (k1.LAUNCHES, k2.LAUNCHES)
        film = integ.render(cam, scene)
        if where.type == "cuda":
            torch.cuda.synchronize()
        launches = (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1])
        expect = (0, 0) if where.type == "cpu" else expect_card(integ, cam)
        if launches != expect:
            raise AssertionError(f"{what} on {where} launched (K1, K2) "
                                 f"{launches} times, expected {expect}")
        films[where.type] = film.cpu().numpy()
        rays[where.type] = integ.last_ray_count
        if where.type == "cuda":
            card = launches
    return films, card, rays


def band_queries(integ, cam, cfg, n_lights: int) -> int:
    """Closest-hit and shadow queries of one render: per band-frame, one
    closest hit a bounce, and per bounce but the last one shadow ray a
    light sampled ("ref" MIS: and one BSDF-branch closest hit each)."""
    _, n_bands = integ.band_layout(cam)
    lights = n_lights if cfg.light_strategy == "all" else 1
    per = 1 if cfg.mis_mode == "onesample" else 2
    return n_bands * integ.spp * (cfg.max_depth + 1
                                  + per * lights * cfg.max_depth)


def feature_scene(dev, resolution, xml: str):
    """The feature scene's camera and TracedScene on ``dev``, with the
    seconds of load_mitsuba (XML, PNG, OBJ, HDR and its tables, upload)
    and of TracedScene.create, each synchronised."""
    import torch

    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    sync()
    t0 = time.perf_counter()
    cam, sd, _ = load_mitsuba(xml, resolution=resolution, device=dev)
    sync()
    t1 = time.perf_counter()
    scene = TracedScene.create(sd)
    sync()
    return cam, scene, t1 - t0, time.perf_counter() - t1


def phase_mitsuba_golden(dev, xml: str):
    from pathtracer_tpu_torch.integrator import PathConfig

    cfg = PathConfig(max_depth=3)

    def make(where):
        cam, scene, _, _ = feature_scene(where, (64, 64), xml)
        return cam, scene
    films, launches, rays = render_both(
        dev, make, cfg, 2,
        lambda integ, cam: (0, band_queries(integ, cam, cfg, 3)),
        "mitsuba golden")
    out = dict(phase="mitsuba_golden", resolution=[64, 64], spp=2,
               max_depth=cfg.max_depth, mis_mode=cfg.mis_mode,
               **card_vs_cpu(films, "mitsuba golden"),
               k1_launches=launches[0], launches=launches[1],
               rays_card=rays["cuda"], rays_cpu=rays["cpu"])
    emit(out)
    return out


def phase_mitsuba_main(dev, smi: str, xml: str):
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1

    torch.cuda.reset_peak_memory_stats(dev)
    cam, scene, load_s, create_s = feature_scene(dev, SLICE_RES, xml)
    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    t0 = time.perf_counter()
    PathIntegrator(cfg, spp=1).render(cam, scene)  # warm-up, 1 spp
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    integ = PathIntegrator(cfg, spp=SLICE_SPP)
    expect = band_queries(integ, cam, cfg, scene.n_lights)
    film, runs = timed_renders(integ, cam, scene, {k2: expect, k1: 0},
                               "mitsuba feature scene")
    check_film(film, SLICE_RES, "mitsuba feature scene")
    if not runs["texture_launches"]["texture_eval"] > 0:
        raise AssertionError("mitsuba feature scene never launched K3")
    _, n_bands = integ.band_layout(cam)
    out = dict(phase="mitsuba_main", resolution=list(SLICE_RES),
               triangles=int(scene.tri_pack.shape[0]),
               lights=scene.n_lights, materials=list(scene.mat_set),
               table_rows=int(scene.bw_rows.shape[0]),
               depth=scene.bw_depth, spp=integ.spp,
               max_depth=cfg.max_depth, mis_mode=cfg.mis_mode,
               bands=n_bands, **runs, warmup_1spp_seconds=warm_s,
               load_seconds=load_s, create_seconds=create_s,
               launches=k2.LAUNCHES, expected_launches=expect,
               k1_launches=k1.LAUNCHES,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               bad_samples=integ.bad_sample_count,
               film_mean_rgb=[float(v) for v in
                              film[..., :3].mean(dim=(0, 1)).cpu()],
               card=smi)
    emit(out)
    return out


def check_film(film, resolution, what: str) -> None:
    """A main path's film: (H, W, 4), finite, positive weight everywhere."""
    import torch

    w, h = resolution
    if tuple(film.shape) != (h, w, 4):
        raise AssertionError(f"{what}: film shape {tuple(film.shape)}")
    if not bool(torch.isfinite(film).all()):
        raise AssertionError(f"{what}: film has non-finite values")
    if not bool((film[..., 3] > 0).all()):
        raise AssertionError(f"{what}: film weight must be positive "
                             "everywhere")


def phase_samplers_main(dev, smi: str):
    """Cornell 640x480, 16 spp, depth 5, onesample under each sampler
    configuration: a 32x32 card film against the CPU's, then three timed
    renders (the cornell main path has warmed K1 and the shading ops)."""
    import torch

    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    out = dict(phase="samplers_main", resolution=list(SLICE_RES),
               spp=SLICE_SPP, max_depth=5, mis_mode="onesample", card=smi)
    for sampler, strategy in SAMPLER_CONFIGS:
        name = f"{sampler}_{strategy}"
        check_cfg = PathConfig(max_depth=3, mis_mode="onesample",
                               sampler=sampler, light_strategy=strategy)

        def make(where, res=(32, 32)):
            cam, sd, _ = load_mitsuba(CORNELL, resolution=res, device=where)
            return cam, TracedScene.create(sd)
        films, launches, rays = render_both(
            dev, make, check_cfg, 2,
            lambda integ, cam: (band_queries(integ, cam, check_cfg, 2), 0),
            f"cornell {name} check")
        check = dict(**card_vs_cpu(films, f"cornell {name}"),
                     launches=launches[0], rays_card=rays["cuda"],
                     rays_cpu=rays["cpu"])
        cfg = PathConfig(max_depth=5, mis_mode="onesample", sampler=sampler,
                         light_strategy=strategy)
        torch.cuda.reset_peak_memory_stats(dev)
        cam, scene = make(dev, SLICE_RES)
        integ = PathIntegrator(cfg, spp=SLICE_SPP)
        expect = band_queries(integ, cam, cfg, scene.n_lights)
        film, runs = timed_renders(integ, cam, scene, {k1: expect},
                                   f"cornell {name}")
        check_film(film, SLICE_RES, f"cornell {name}")
        out[name] = dict(sampler=sampler, light_strategy=strategy,
                         check_32=check, **runs, launches=k1.LAUNCHES,
                         bsdf_host=bsdf_host_cost(integ, cam, scene),
                         expected_launches=expect,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                         bad_samples=integ.bad_sample_count,
                         film_mean_rgb=[float(v) for v in
                                        film[..., :3].mean(dim=(0, 1)).cpu()])
    emit(out)
    return out


def bsdf_host_cost(integ, cam, scene) -> dict:
    """One more render of an eager path with K5's and K6's wrappers on a
    host clock (each call's checks, allocations and enqueue; no
    synchronise inside): their calls, host microseconds a call, the share
    of the render's wall time they take, and the render's Mrays/s."""
    import torch

    from pathtracer_tpu_torch.ops.cuda import bsdf_cu

    calls = dict(eval=bsdf_cu.bsdf_eval, sample=bsdf_cu.bsdf_sample)
    spent = dict(eval=[0, 0.0], sample=[0, 0.0])

    def clocked(kind):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            result = calls[kind](*args, **kwargs)
            spent[kind][0] += 1
            spent[kind][1] += time.perf_counter() - t0
            return result
        return call

    bsdf_cu.bsdf_eval, bsdf_cu.bsdf_sample = clocked("eval"), \
        clocked("sample")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integ.render(cam, scene)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        bsdf_cu.bsdf_eval, bsdf_cu.bsdf_sample = calls["eval"], \
            calls["sample"]
    return dict(calls={k: n for k, (n, _) in spent.items()},
                host_us_per_call={k: sec / n * 1e6
                                  for k, (n, sec) in spent.items() if n},
                host_share=sum(sec for _, sec in spent.values()) / wall,
                seconds=wall,
                mrays_per_s=integ.last_ray_count / wall / 1e6)


def lt_queries(tracer, scene) -> int:
    """The light tracer's queries of one render: a wave traces depth
    closest hits and depth camera connections, and one more from the
    emission vertex where the scene has area lights."""
    from pathtracer_tpu_torch.scene.scene import LIGHT_AREA

    depth = tracer.cfg.max_depth
    return tracer.waves * (2 * depth + (LIGHT_AREA in scene.light_set))


def phase_lighttrace(dev, smi: str):
    """LightTracer at the reference's defaults on cornell (K1) and on
    config B (point and distant lights, K2): a 32x32 card film against
    the CPU's on the same host-made draws (LT_CHECK_RMSE), then a warm-up
    and three timed 640x480 renders with exact launch counts."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, TracedScene
    from pathtracer_tpu_torch.integrator_lt import LightTracer
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.ops.cuda import texture_cu as tx
    from pathtracer_tpu_torch.scene import procedural
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    def cornell(where, res):
        cam, sd, _ = load_mitsuba(CORNELL, resolution=res, device=where)
        return cam, TracedScene.create(sd)

    def config_b(where, res):
        cam, sd = procedural.small_scene(res, device=where)
        return cam, TracedScene.create(sd)

    cfg = PathConfig(max_depth=LT_DEPTH)
    out = dict(phase="lighttrace", resolution=list(LT_RES), paths=LT_PATHS,
               wave=LT_WAVE, max_depth=LT_DEPTH, card=smi)
    for name, make, kernel in (("cornell", cornell, k1),
                               ("config_b", config_b, k2)):
        other = k2 if kernel is k1 else k1
        films = {}
        for where in (torch.device("cpu"), dev):
            cam, scene = make(where, (32, 32))
            tracer = LightTracer(cfg, paths=LT_CHECK_PATHS,
                                 wave=LT_WAVE)
            before = (kernel.LAUNCHES, other.LAUNCHES)
            films[where.type] = tracer.render(cam, scene).cpu().numpy()
            got = (kernel.LAUNCHES - before[0], other.LAUNCHES - before[1])
            want = (0, 0) if where.type == "cpu" else \
                (lt_queries(tracer, scene), 0)
            if got != want:
                raise AssertionError(f"light tracer check on {name}, "
                                     f"{where}: launched {got}, expected "
                                     f"{want}")
        got, want = films["cuda"], films["cpu"]
        if not np.isfinite(got).all() or not (got[..., 3] == 1).all():
            raise AssertionError(f"light tracer {name}: card film not "
                                 "finite or alpha not 1")
        mean = float(want[..., :3].mean())
        diff = np.abs(got[..., :3] - want[..., :3])
        check = dict(paths=LT_CHECK_PATHS, film_mean=mean,
                     rmse_over_mean=float(np.sqrt(np.mean(diff ** 2)))
                     / mean,
                     sum_rel_diff=abs(float(got[..., :3].sum())
                                      - float(want[..., :3].sum()))
                     / float(want[..., :3].sum()),
                     max_abs_diff=float(diff.max()),
                     pixels_over_1e_3_rel=int(
                         (diff.max(-1) > 1e-3 * mean).sum()))
        if not (mean > 0 and check["rmse_over_mean"] < LT_CHECK_RMSE):
            raise AssertionError(f"light tracer {name}: card vs CPU "
                                 f"{check}")

        torch.cuda.reset_peak_memory_stats(dev)
        cam, scene = make(dev, LT_RES)
        tracer = LightTracer(cfg, paths=LT_PATHS, wave=LT_WAVE)
        expect = lt_queries(tracer, scene)
        t0 = time.perf_counter()
        tracer.render(cam, scene)  # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        seconds = []
        for _ in range(RENDER_REPS):
            kernel.LAUNCHES = 0  # the main path's run starts here
            other.LAUNCHES = 0
            for key in tx.LAUNCHES:
                tx.LAUNCHES[key] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            film = tracer.render(cam, scene)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if (kernel.LAUNCHES, other.LAUNCHES) != (expect, 0):
                raise AssertionError(
                    f"light tracer {name} launched "
                    f"{(kernel.LAUNCHES, other.LAUNCHES)}, expected "
                    f"{(expect, 0)}")
        w, h = LT_RES
        if tuple(film.shape) != (h, w, 4) or \
                not bool(torch.isfinite(film).all()) or \
                not float(film[..., :3].sum()) > 0:
            raise AssertionError(f"light tracer {name}: film not finite "
                                 "or empty")
        rates = [tracer.last_ray_count / dt / 1e6 for dt in seconds]
        out[name] = dict(
            kernel=kernel.__name__.rsplit(".", 1)[-1],
            triangles=int(scene.tri_pack.shape[0]),
            light_set=list(scene.light_set), check_32=check,
            rays=tracer.last_ray_count, seconds=statistics.median(seconds),
            seconds_runs=seconds, mrays_per_s=statistics.median(rates),
            mrays_per_s_min=min(rates), mrays_per_s_max=max(rates),
            paths_per_s=tracer.paths / statistics.median(seconds),
            warmup_seconds=warm_s, launches=kernel.LAUNCHES,
            expected_launches=expect, texture_launches=dict(tx.LAUNCHES),
            peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
            film_mean_rgb=[float(v) for v in
                           film[..., :3].mean(dim=(0, 1)).cpu()])
    emit(out)
    return out


def sharded_scene(name: str, resolution, device):
    """(camera, TracedScene) of cornell (K1) or config B (K2)."""
    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.scene import procedural
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    if name == "cornell":
        cam, sd, _ = load_mitsuba(CORNELL, resolution=resolution,
                                  device=device)
    else:
        cam, sd = procedural.small_scene(resolution, device=device)
    return cam, TracedScene.create(sd)


def sharded_rank(device, jobs):
    """One rank of a ``parallel.mesh.launch``: for each job (scene name,
    mesh, spp) at SHARD_RES, depth 5, "onesample", a warm-up
    ``render_sharded``, then one timed with the kernel counts set to 0
    just before it. Returns each job's film (host), seconds and (K1, K2)
    launches."""
    import torch
    import torch.distributed as dist

    from pathtracer_tpu_torch.integrator import PathConfig
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.parallel.mesh import render_sharded

    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    out = []
    for name, mesh, spp in jobs:
        cam, scene = sharded_scene(name, SHARD_RES, device)
        render_sharded(cam, scene, mesh, cfg, spp=spp)  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        k1.LAUNCHES = 0  # the main path's run starts here
        k2.LAUNCHES = 0
        t0 = time.perf_counter()
        film = render_sharded(cam, scene, mesh, cfg, spp=spp)
        torch.cuda.synchronize()
        out.append(dict(rank=dist.get_rank(), film=film.cpu(),
                        seconds=time.perf_counter() - t0,
                        launches=(k1.LAUNCHES, k2.LAUNCHES)))
    return out


def shard_queries(resolution, mesh, cfg, spp: int) -> int:
    """Closest-hit and shadow queries of one rank's share of a sharded
    one-light render: its band in waves of at most WAVE_LANES lanes,
    times its frames, times a frame's queries (band_queries)."""
    from pathtracer_tpu_torch.core.film import sample_bounds
    from pathtracer_tpu_torch.integrator import PathIntegrator

    (x0, y0), (x1, y1) = sample_bounds(*resolution)
    band = -(-(y1 - y0) // mesh.shape["tiles"])
    wave_rows = PathIntegrator(cfg, spp=spp).wave_rows(x1 - x0, band)
    per = 1 if cfg.mis_mode == "onesample" else 2
    return (-(-band // wave_rows) * (spp // mesh.shape.get("samples", 1))
            * (cfg.max_depth + 1 + per * cfg.max_depth))


def phase_sharded(dev, smi: str):
    """``render_sharded`` in spawned ranks, all on card 0, against the
    single process's card film: cornell at the main path's configuration
    on one NCCL rank (``torch.equal``), on two gloo ranks and on a 2 x 2
    gloo mesh, config B through K2 on two gloo ranks (SHARD_ATOL /
    SHARD_RTOL); each rank's launches exact, their wall time and the
    aggregate Mrays/s."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.parallel.mesh import (launch, make_mesh,
                                                    make_mesh_2d)

    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    spps = dict(cornell=SHARD_SPP, config_b=SHARD_B_SPP)
    single = {}
    for name, spp in spps.items():
        cam, scene = sharded_scene(name, SHARD_RES, dev)
        integ = PathIntegrator(cfg, spp=spp)
        integ.render(cam, scene)  # warm-up
        torch.cuda.synchronize()
        before = (k1.LAUNCHES, k2.LAUNCHES)
        t0 = time.perf_counter()
        film = integ.render(cam, scene)
        torch.cuda.synchronize()
        single[name] = dict(
            film=film.cpu(), seconds=time.perf_counter() - t0,
            rays=integ.last_ray_count,
            launches=(k1.LAUNCHES - before[0], k2.LAUNCHES - before[1]))
    runs = {"a_nccl_1": ("nccl", "cuda", [("cornell", make_mesh(1)),
                                          ("config_b", make_mesh(1))]),
            "b_gloo_2": ("gloo", "cuda:0", [("cornell", make_mesh(2)),
                                            ("config_b", make_mesh(2))]),
            "c_gloo_2x2": ("gloo", "cuda:0",
                           [("cornell", make_mesh_2d(2, 2))])}
    out = dict(phase="sharded", resolution=list(SHARD_RES),
               max_depth=cfg.max_depth, mis_mode=cfg.mis_mode,
               atol=SHARD_ATOL, rtol=SHARD_RTOL, card=smi,
               single={name: dict(seconds=s["seconds"], rays=s["rays"],
                                  mrays_per_s=s["rays"] / s["seconds"] / 1e6,
                                  launches=s["launches"])
                       for name, s in single.items()})
    # the one-rank run's Mrays/s: a fresh process, as every rank is (this
    # process has run every earlier phase)
    one_rank = {}
    for run, (backend, device, jobs) in runs.items():
        t0 = time.perf_counter()
        ranks = launch(jobs[0][1].size, sharded_rank,
                       [(name, mesh, spps[name]) for name, mesh in jobs],
                       device=device, backend=backend)
        launch_s = time.perf_counter() - t0
        for j, (name, mesh) in enumerate(jobs):
            want = single[name]
            films = [r[j]["film"] for r in ranks]
            if run.startswith("a"):
                if not torch.equal(films[0], want["film"]):
                    diff = float((films[0] - want["film"]).abs().max())
                    raise AssertionError(f"sharded {run} {name}: film not "
                                         f"equal to the single process's "
                                         f"(largest difference {diff})")
            else:
                for film in films:
                    np.testing.assert_allclose(
                        film.numpy(), want["film"].numpy(), rtol=SHARD_RTOL,
                        atol=SHARD_ATOL, err_msg=f"sharded {run} {name}")
            q = shard_queries(SHARD_RES, mesh, cfg, spps[name])
            expect = (q, 0) if name == "cornell" else (0, q)
            launches = [tuple(r[j]["launches"]) for r in ranks]
            if any(got != expect for got in launches):
                raise AssertionError(f"sharded {run} {name}: rank launches "
                                     f"{launches}, expected {expect} each")
            seconds = [r[j]["seconds"] for r in ranks]
            rate = want["rays"] / max(seconds) / 1e6
            one_rank.setdefault(name, rate)
            diff = (films[0] - want["film"]).abs()
            out[f"{run}_{name}"] = dict(
                backend=backend, device=device, ranks=mesh.size,
                mesh=dict(mesh.shape), spp=spps[name],
                launches_by_rank=launches,
                launches_sum=[sum(x) for x in zip(*launches)],
                single_launches=want["launches"],
                seconds_by_rank=seconds, seconds=max(seconds),
                aggregate_mrays_per_s=rate,
                over_one_rank=rate / one_rank[name],
                single_mrays_per_s=want["rays"] / want["seconds"] / 1e6,
                max_abs_diff=float(diff.max()),
                max_rel_diff=float((diff / want["film"].abs().clamp_min(
                    1e-6)).max()),
                pixels_differing=int((diff.amax(-1) > 0).sum()),
                launch_seconds=launch_s)
    emit(out)
    return out


def trace_kernel_launches(path: str, name: str) -> int:
    """The CUDA kernel events whose name contains ``name`` in a
    torch.profiler Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and name in e.get("name", ""))


def phase_cli(dev, smi: str):
    """``python -m pathtracer_tpu_torch.frontend.cli`` on the card, four
    subprocesses at once: a cornell render and the same on one NCCL rank
    (``--mesh 1``; each PNG against ``to_rgb8`` of the render in this
    process), ``--single_pixel`` (its logged mean against
    ``render_single_pixel`` here, rtol 1e-5) and ``--profile`` (the trace
    file; its K1 kernel events, the CLI's own launches, equal to the
    render's queries; bounce 0's logged occupancy equal to the camera
    lanes)."""
    import re

    import numpy as np

    from pathtracer_tpu_torch.core.film import sample_bounds, to_rgb8
    from pathtracer_tpu_torch.frontend.debug import render_single_pixel
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.utils.image import read_png

    w, h = CLI_RES
    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    base = [sys.executable, "-m", "pathtracer_tpu_torch.frontend.cli",
            CORNELL, "-r", f"{w}x{h}", "-s", str(CLI_SPP), "-d",
            str(cfg.max_depth), "--mis", cfg.mis_mode]
    out = dict(phase="cli", resolution=list(CLI_RES), spp=CLI_SPP,
               max_depth=cfg.max_depth, mis_mode=cfg.mis_mode, card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        render_dir = os.path.join(tmp, "render")
        os.makedirs(render_dir)
        prof_dir = os.path.join(tmp, "profile")
        cmds = dict(
            render=base + ["-o", render_dir],
            single_pixel=base + ["-o", os.path.join(tmp, "none.png"),
                                 "--single_pixel",
                                 f"{CLI_PIXEL[0]},{CLI_PIXEL[1]}"],
            profile=base + ["-o", os.path.join(tmp, "profiled.png"),
                            "--profile", prof_dir],
            mesh=base + ["-o", os.path.join(tmp, "mesh.png"), "--mesh",
                         "1"])
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(cmd, cwd=ROOT, text=True,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE)
                 for name, cmd in cmds.items()}
        logs = {}
        for name, proc in procs.items():
            try:
                _, err = proc.communicate(timeout=CLI_TIMEOUT)
            except subprocess.TimeoutExpired:
                for p in procs.values():
                    p.kill()
                raise
            logs[name] = err
            if proc.returncode != 0:
                raise AssertionError(f"cli {name} exited {proc.returncode}:"
                                     f"\n{err[-3000:]}")
        out["seconds"] = time.perf_counter() - t0

        cam, scene = sharded_scene("cornell", CLI_RES, dev)
        integ = PathIntegrator(cfg, spp=CLI_SPP)
        rgb8 = to_rgb8(integ.render(cam, scene))
        for name, path in (("render", os.path.join(render_dir,
                                                   "render.png")),
                           ("mesh", os.path.join(tmp, "mesh.png"))):
            png = read_png(path)[..., :3]
            diff = np.abs(png.astype(np.int32) - rgb8.astype(np.int32))
            if png.shape != rgb8.shape or diff.max() > 1:
                raise AssertionError(f"cli {name}: PNG {png.shape} off "
                                     f"the in-process render by "
                                     f"{diff.max()}")
            out.setdefault(name, {}).update(
                png_bytes_differing=int((diff > 0).sum()),
                png_max_diff=int(diff.max()))

        mean = re.search(r"mean L = \[([^\]]*)\]", logs["single_pixel"])
        if mean is None:
            raise AssertionError("cli --single_pixel logged no mean:\n"
                                 + logs["single_pixel"][-3000:])
        got = [float(v) for v in mean.group(1).split(",")]
        want = render_single_pixel(cam, scene, cfg, CLI_PIXEL, CLI_SPP)
        np.testing.assert_allclose(got, want.mean(0).tolist(), rtol=1e-5,
                                   err_msg="cli --single_pixel mean")
        out["single_pixel"] = dict(pixel=list(CLI_PIXEL), mean=got)

        trace = os.path.join(prof_dir, "trace.json")
        if not os.path.isfile(trace) or not os.path.getsize(trace):
            raise AssertionError("cli --profile wrote no trace")
        occ = [float(v) for v in re.findall(
            r"bounce +\d+: +(\d+) live lanes", logs["profile"])]
        (x0, y0), (x1, y1) = sample_bounds(w, h)
        lanes = (x1 - x0) * (y1 - y0) * CLI_SPP
        if len(occ) != cfg.max_depth + 1 or occ[0] != lanes:
            raise AssertionError(f"cli --profile occupancy {occ}, bounce 0 "
                                 f"should be {lanes}")
        launches = trace_kernel_launches(trace, "intersect_kernel")
        expect = band_queries(integ, cam, cfg, 1)
        if launches != expect:
            raise AssertionError(f"cli --profile trace: {launches} K1 "
                                 f"kernels, expected {expect}")
        out["profile"] = dict(trace_bytes=os.path.getsize(trace),
                              occupancy=occ, camera_lanes=lanes,
                              k1_launches=launches)
    emit(out)
    return out


def phase_viewer(dev, smi: str):
    """The interactive viewer on the card: ``preview_frame`` of cornell
    (K1) and config B (K2) against the CPU's, the BVH overlay, one bounded
    ``run`` (stdin /dev/null, no tev), and the keys r ] h o x with the
    camera that h moved rendered."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.core.controller import OrbitalCameraController
    from pathtracer_tpu_torch.frontend import interactive as iv
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.utils.image import read_png

    out = dict(phase="viewer", resolution=list(VIEW_RES), card=smi)
    for name, kernel in (("cornell", k1), ("config_b", k2)):
        imgs = {}
        for where in (torch.device("cpu"), dev):
            cam, scene = sharded_scene(name, VIEW_RES, where)
            before = kernel.LAUNCHES
            imgs[where.type] = iv.preview_frame(cam, scene, wire=True)
            launches = kernel.LAUNCHES - before
            if launches != (1 if where.type == "cuda" else 0):
                raise AssertionError(f"viewer preview {name} on {where}: "
                                     f"{launches} launches")
        np.testing.assert_allclose(imgs["cuda"], imgs["cpu"], rtol=0,
                                   atol=1e-4, err_msg=f"preview {name}")
        out[f"preview_{name}"] = dict(
            max_abs_diff=float(np.abs(imgs["cuda"] - imgs["cpu"]).max()),
            launches=1)
        if name == "config_b":
            img = imgs["cuda"]
            marked = np.any(iv.draw_bvh_bounds(img.copy(), cam, scene)
                            != img, axis=-1)
            if not marked.any():
                raise AssertionError("draw_bvh_bounds marked no pixel")
            out["bvh_bounds"] = dict(boxes=len(iv.bvh_level_boxes(scene)),
                                     pixels_marked=int(marked.sum()))

    cfg = PathConfig(max_depth=5, mis_mode="onesample")
    cam, scene = sharded_scene("cornell", VIEW_RES, dev)
    integ = PathIntegrator(cfg, spp=4)
    stdin = sys.stdin
    with tempfile.TemporaryDirectory() as tmp, open(os.devnull) as null:
        png_path = os.path.join(tmp, "frame.png")
        before = k1.LAUNCHES
        sys.stdin = null
        try:
            film = iv.run(cam, scene, integ, png_path,
                          server_address="127.0.0.1:1", max_frames=1)
        finally:
            sys.stdin = stdin
        check_film(film, VIEW_RES, "viewer run")
        png = read_png(png_path)
        expect = band_queries(integ, cam, cfg, 1)
        if k1.LAUNCHES - before != expect or \
                png.shape[:2] != tuple(film.shape[:2]):
            raise AssertionError(f"viewer run: {k1.LAUNCHES - before} K1 "
                                 f"launches (expected {expect}), PNG "
                                 f"{png.shape}")
    out["run"] = dict(launches=expect, png_shape=list(png.shape))

    p0 = scene.data.p0.cpu().numpy()
    ctl = OrbitalCameraController(0.5 * (p0.min(0) + p0.max(0)))
    state = iv.ViewerState(camera=cam, spp=4, controller=ctl)
    for key in "r]hox":
        iv.dispatch_key(state, key)
    if not (state.restart and state.spp == 8 and state.dirty and state.save
            and state.quit):
        raise AssertionError(f"viewer keys r ] h o x gave {state}")
    moved = ctl.update_camera(state.camera, dt=1.0)
    before = k1.LAUNCHES
    film2 = PathIntegrator(cfg, spp=state.spp).render(moved, scene)
    check_film(film2, VIEW_RES, "viewer moved camera")
    if torch.equal(film2, film) or \
            k1.LAUNCHES - before != 2 * expect:
        raise AssertionError("viewer: the moved camera's render")
    out["keys"] = dict(spp=state.spp, eye_moved=float(np.linalg.norm(
        moved.cam_to_world[:3, 3] - cam.cam_to_world[:3, 3])),
        launches=k1.LAUNCHES - before)
    emit(out)
    return out


def render_profile(cam, scene, spp: int, kernel: str,
                   annotation: str | None = None, warmup: bool = True,
                   kernels: tuple = ()) -> dict:
    """One render (depth 5, "onesample") under torch.profiler: the device
    time of all its kernels, the share of it of the kernels whose name
    contains ``kernel``, the launches, and the device's busy share of the
    traced render's wall time (the trace slows the host, so the share is
    a lower bound), after one untraced warm-up render of the same
    configuration (unless ``warmup`` is false). With ``annotation``, the
    host's ops are traced too, and the device time of the kernels that
    torch ops inside the ``record_function`` ranges of that name launched
    is reported with its share (``annotated_device_ms``,
    ``annotation_share``), and how many of the named kernels link to
    their launch's ``pt::k:`` span (``hand_linked``). ``kernels`` names
    more kernels whose device
    time, launches and share are reported by name (``by_kernel``).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator

    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=spp)
    _, n_bands = integ.band_layout(cam)
    if warmup:
        integ.render(cam, scene)
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if annotation is not None:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        integ.render(cam, scene)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_parse = time.perf_counter()
    names = (kernel,) + tuple(kernels)
    if annotation is None:
        events = prof.key_averages()
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        launches = sum(e.count for e in events)
        named = {name: (sum(e.self_device_time_total for e in events
                            if name in e.key) / 1e3,
                        sum(e.count for e in events if name in e.key))
                 for name in names}
        extra = {}
    else:
        device_ms, launches, named, extra = annotated_device_ms(
            prof.profiler.kineto_results.events(), names, annotation)
        extra["annotation_share"] = extra["annotated_device_ms"] / device_ms
    k_ms, k_launches = named[kernel]
    if device_ms <= 0 or not k_launches:
        raise AssertionError("profiler saw no device time for the render")
    return dict(device_ms=device_ms, kernel=kernel, kernel_device_ms=k_ms,
                kernel_share=k_ms / device_ms, kernel_launches=k_launches,
                by_kernel={name: dict(device_ms=ms, launches=n,
                                      share=ms / device_ms)
                           for name, (ms, n) in named.items()
                           if name != kernel},
                launches=launches,
                launches_per_band_frame=launches / (n_bands * integ.spp),
                traced_wall_ms=wall_ms, device_busy_share=device_ms / wall_ms,
                **extra, parse_seconds=time.perf_counter() - t_parse)


def annotated_device_ms(events, names: tuple, annotation: str):
    """From a host-and-device trace's raw events (torch.profiler's Kineto
    events, read without building its event tree, which takes minutes
    for a whole render): the device time and count of every device
    event, of those whose name contains each of ``names``, and of the
    kernels launched by host ops that start inside a ``record_function``
    range named ``annotation``: those whose runtime call (``cudaLaunchKernel``
    inside the torch op, or, for a band-frame replayed from CUDA graphs,
    the ``cudaGraphLaunch`` that the replay makes inside the same ranges,
    ``utils/span_graph.py``) starts inside it, and not inside a hand
    kernel's ``pt::k:<kernel>`` span. A hand kernel's correlation id names
    the launch inside its ``pt::k:`` span, so the hand kernels are
    counted by name, with how many of each name link so to a ``pt::k:``
    span (``hand_linked``). The device-side copies of the ranges are not
    work and are left out. Returns (device_ms, launches, {name:
    (device_ms, launches)}, {annotation, annotation_ranges,
    annotated_device_ms, annotated_launches, hand_linked})."""
    import bisect

    from torch.autograd import DeviceType

    host, device = [], []
    for e in events:
        (host if e.device_type() == DeviceType.CPU else device).append(e)

    def within(match):
        """Whether a host time lies in a range whose name ``match``es
        (ranges of one name do not nest)."""
        ranges = sorted((e.start_ns(), e.end_ns()) for e in host
                        if match(e.name()))
        starts = [r[0] for r in ranges]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t < ranges[i][1]
        return inside, len(ranges)

    in_annotation, n_ranges = within(lambda n: n == annotation)
    if not n_ranges:
        raise AssertionError(f"the trace holds no {annotation} range")
    in_launch, _ = within(lambda n: n.startswith("pt::k:"))
    runtime = {e.correlation_id(): e.start_ns() for e in host
               if e.name().startswith("cu")}
    device = [e for e in device
              if not e.is_user_annotation() and e.name() != annotation]
    named = {name: (sum(e.duration_ns() for e in device
                        if name in e.name()) / 1e6,
                    sum(1 for e in device if name in e.name()))
             for name in names}
    hand_linked = {name: sum(
        1 for e in device if name in e.name()
        and e.correlation_id() in runtime
        and in_launch(runtime[e.correlation_id()]))
        for name in names}
    by_op = [e.duration_ns() for e in device
             if e.correlation_id() in runtime
             and in_annotation(runtime[e.correlation_id()])
             and not in_launch(runtime[e.correlation_id()])]
    extra = dict(annotation=annotation, annotation_ranges=n_ranges,
                 annotated_device_ms=sum(by_op) / 1e6,
                 annotated_launches=len(by_op), hand_linked=hand_linked)
    return (sum(e.duration_ns() for e in device) / 1e6, len(device), named,
            extra)


def cornell_render_profile(dev, spp: int = PROFILE_CORNELL_SPP) -> dict:
    """Phase 5's cornell render at ``spp`` under the profiler
    (``render_profile``): K1's share."""
    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(CORNELL, resolution=(640, 480), device=dev)
    return render_profile(cam, TracedScene.create(sd), spp,
                          "intersect_kernel")


def box_render_profile(dev) -> dict:
    """Phase 8's box-field render under the profiler
    (``render_profile``): K2's share."""
    cam, scene, _ = box_scene(dev)
    return render_profile(cam, scene, 2, "bvhw_kernel")


def phase_profile(dev, k1_sets: dict, alpha_set: tuple, tex_calls: dict,
                  bsdf_calls: dict, sobol_calls: dict):
    """Device times from a torch.profiler trace: K1's and K2's at the
    shapes of phases 3 and 6 (K2 also on Sponza's alpha table, phase 16's
    rays), K3's and K4's on the calls of ``texture_kernels``, K5's and
    K6's on those of ``bsdf_kernels``, K7's and the plain chain's (all the
    device work of a call) on those of ``sobol_kernels``, P1-P9's and
    their library calls' at the probes' shapes (all the device work of a
    call); then a whole cornell and box-field render. It
    runs after every timed render of this process but phase 24's
    reference renders (the Sponza profile and phases 24-26 follow; the
    timed sharded renders run in fresh processes): an active CUPTI trace
    slows every later launch of the host-bound render."""
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.probes import gather as pg
    from pathtracer_tpu_torch.probes import gather2 as pg2

    scene, o, d, t_max = k1_sets["k1"]
    tri_pack = scene.tri_pack
    k1_ms = kernel_device_ms(lambda: k1.intersect(o, d, t_max, tri_pack),
                             "intersect_kernel")
    k1_any_ms = kernel_device_ms(
        lambda: k1.intersect(o, d, t_max, tri_pack, any_hit=True),
        "intersect_kernel")
    _, ro, rd, t_live, t_inf = k1_sets["render"]
    k1_render_ms = kernel_device_ms(
        lambda: k1.intersect(ro, rd, t_live, tri_pack), "intersect_kernel")
    k1_render_inf_ms = kernel_device_ms(
        lambda: k1.intersect(ro, rd, t_inf, tri_pack), "intersect_kernel")
    scene, o, d, t_inf, t_any = k2_inputs(dev)
    k2_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(scene.bw_rows, o, d, t_inf,
                                  stackw=scene.bw_depth), "bvhw_kernel")
    k2_any_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(scene.bw_rows, o, d, t_any, any_hit=True,
                                  stackw=scene.bw_depth), "bvhw_kernel")
    table, stackw, o, d, t_inf, t_any = alpha_set
    k2_alpha_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(table, o, d, t_inf, stackw=stackw),
        "bvhw_kernel")
    k2_alpha_any_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(table, o, d, t_any, any_hit=True,
                                  stackw=stackw), "bvhw_kernel")
    scene, o, d, t_live, t_any = k2_bounce_inputs(dev)
    k2_bounce_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(scene.bw_rows, o, d, t_live,
                                  stackw=scene.bw_depth), "bvhw_kernel")
    k2_bounce_any_ms = kernel_device_ms(
        lambda: k2.bvhw_intersect(scene.bw_rows, o, d, t_any, any_hit=True,
                                  stackw=scene.bw_depth), "bvhw_kernel")
    texture_ms = {case: kernel_device_ms(fn, name)
                  for case, (name, fn) in tex_calls.items()}
    bsdf_ms = {case: kernel_device_ms(fn, name)
               for case, (name, fn) in bsdf_calls.items()}
    sobol_ms = {case: kernel_device_ms(fn, name)
                for case, (name, fn) in sobol_calls.items()}
    x, x2 = pg.probe_inputs(dev), pg2.probe_inputs(dev)
    one, one2 = one_lane(x), one_row(x2)
    floor_ms = {pid: kernel_device_ms(lambda: fn(one))
                for pid, fn in pg.PROBES.items()}
    floor_ms.update({pid: kernel_device_ms(lambda: fn(one2))
                     for pid, fn in pg2.PROBES.items()})
    probe_ms, library_ms = {}, {}
    for probes, inputs, library in ((pg.PROBES, x, probe_library(x)),
                                    (pg2.PROBES, x2, probe2_library(x2))):
        for pid, fn in probes.items():
            probe_ms[pid] = kernel_device_ms(lambda: fn(inputs))
        for pid, fn in library.items():
            if fn is not None:
                library_ms[pid] = kernel_device_ms(fn)
    out = dict(phase="profile", k1_kernel_device_ms=k1_ms,
               k1_anyhit_kernel_device_ms=k1_any_ms,
               k1_render_kernel_device_ms=k1_render_ms,
               k1_render_t_inf_kernel_device_ms=k1_render_inf_ms,
               k2_kernel_device_ms=k2_ms,
               k2_anyhit_kernel_device_ms=k2_any_ms,
               k2_bounce_kernel_device_ms=k2_bounce_ms,
               k2_bounce_anyhit_kernel_device_ms=k2_bounce_any_ms,
               k2_alpha_kernel_device_ms=k2_alpha_ms,
               k2_alpha_anyhit_kernel_device_ms=k2_alpha_any_ms,
               texture_kernel_device_ms=texture_ms,
               bsdf_kernel_device_ms=bsdf_ms,
               sobol_kernel_device_ms=sobol_ms,
               probe_kernel_device_ms=probe_ms,
               probe_floor_device_ms=floor_ms,
               library_device_ms=library_ms, reps=K1_REPS,
               cornell_render=cornell_render_profile(dev),
               box_render=box_render_profile(dev))
    emit(out)
    return out


def phase_build():
    """Compile every native source at once (one compiler process each)."""
    from pathtracer_tpu_torch.accel import cpp
    from pathtracer_tpu_torch.ops.cuda import _build
    from pathtracer_tpu_torch.ops.cuda import bsdf_cu as k56
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
    from pathtracer_tpu_torch.ops.cuda import env_cu as k8
    from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
    from pathtracer_tpu_torch.ops.cuda import sobol_cu as k7
    from pathtracer_tpu_torch.ops.cuda import texture_cu as tx
    from pathtracer_tpu_torch.probes import gather as pg
    from pathtracer_tpu_torch.probes import gather2 as pg2

    def timed(build):
        t0 = time.perf_counter()
        path = build()
        return os.path.relpath(path, ROOT), time.perf_counter() - t0

    builds = dict(pylaunch=_build.build_pylaunch,
                  intersect=lambda: k1.build(verbose=True),
                  bvhw=lambda: k2.build(verbose=True),
                  texture=lambda: tx.build(verbose=True),
                  bsdf=lambda: k56.build(verbose=True),
                  sobol=lambda: k7.build(verbose=True),
                  env=lambda: k8.build(verbose=True),
                  gather_probe=lambda: pg.build(verbose=True),
                  gather_probe2=lambda: pg2.build(verbose=True),
                  bvh_builder=cpp.library_path)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        done = {name: fut.result() for name, fut in futures.items()}
    k1._load()
    k2._load()
    tx._load()
    k56._load()
    k7._load()
    k8._load()
    pg._load()
    pg2._load()
    cpp._load()
    probe_ptxas = _build.ptxas_report(pg.build())
    out = dict(phase="build", seconds=time.perf_counter() - t0,
               libraries={name: dict(path=path, seconds=sec)
                          for name, (path, sec) in done.items()},
               probe_ptxas=probe_ptxas,
               probe2_ptxas=_build.ptxas_report(pg2.build()),
               texture_ptxas=_build.ptxas_report(tx.build()),
               bsdf_ptxas=_build.ptxas_report(k56.build()),
               sobol_ptxas=_build.ptxas_report(k7.build()),
               env_ptxas=_build.ptxas_report(k8.build()),
               p8_rows=pg2.macro("P8_ROWS"),
               p1_threads=pg.threads("P1"), p3_threads=pg.threads("P3"),
               p4_threads=pg.threads("P4"), p4_rows=pg.macro("P4_ROWS"),
               p5_threads=pg.threads("P5"),
               p5_slab_bytes=4 * pg.D * pg.threads("P5"))
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
    k1_sets = dict(k1=k1_inputs(dev), render=k1_render_inputs(dev))
    k1_out = phase_k1(dev, k1_sets)
    phase_golden(dev)
    main_out = phase_main(dev, smi)
    k2_out = phase_k2(dev)
    phase_box_golden(dev)
    box_out = phase_box_main(dev, smi)
    probe_out = phase_probes(dev)
    probe2_out = phase_probes2(dev)
    phase_materials_golden(dev)
    mat_out = phase_materials_main(dev, smi)
    phase_classroom_golden(dev)
    class_out, class_cam, class_scene = phase_classroom_main(dev, smi)
    sponza_gold, alpha_set = phase_sponza_golden(dev)
    sponza_out, sponza_cam, sponza_scene = phase_sponza_main(dev, smi)
    tex_out, tex_calls = phase_texture_kernels(
        dev, class_cam, class_scene, sponza_cam, sponza_scene, alpha_set)
    bsdf_out, bsdf_calls = phase_bsdf_kernels(dev)
    sobol_out, sobol_calls = phase_sobol_kernels(dev)
    env_out = phase_env_kernels(dev)
    routes_out = phase_alpha_routes(dev)
    t_slice = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import torch_mitsuba_scenes
        xml = torch_mitsuba_scenes.write_feature_scene(tmp)
        phase_mitsuba_golden(dev, xml)
        feature_out = phase_mitsuba_main(dev, smi, xml)
    samplers_out = phase_samplers_main(dev, smi)
    lt_out = phase_lighttrace(dev, smi)
    emit(dict(phase="slice_total", seconds=time.perf_counter() - t_slice,
              phases=["mitsuba_golden", "mitsuba_main", "samplers_main",
                      "lighttrace"]))
    prof_out = phase_profile(dev, k1_sets, alpha_set, tex_calls,
                             bsdf_calls, sobol_calls)
    phase_sponza_profile(sponza_cam, sponza_scene)
    # after the profiles: with these phases before them, phase 13's first
    # three traces once held no kernel activity (a later run that traced
    # after each of these phases did not reproduce it)
    t_slice = time.perf_counter()
    sharded_out = phase_sharded(dev, smi)
    cli_out = phase_cli(dev, smi)
    viewer_out = phase_viewer(dev, smi)
    emit(dict(phase="slice_total", seconds=time.perf_counter() - t_slice,
              phases=["sharded", "cli", "viewer"]))

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
             launches_by_path=dict(
                 main=main_out["launches"],
                 alpha_brute=routes_out["brute"]["k1_launches"],
                 sponza_main=sponza_out["k1_launches"],
                 mitsuba_main=feature_out["k1_launches"],
                 **{f"samplers_main_{sampler}_{strategy}":
                    samplers_out[f"{sampler}_{strategy}"]["launches"]
                    for sampler, strategy in SAMPLER_CONFIGS},
                 lighttrace_cornell=lt_out["cornell"]["launches"],
                 **{f"sharded_{run}": sharded_out[f"{run}_cornell"][
                     "launches_sum"][0]
                    for run in ("a_nccl_1", "b_gloo_2", "c_gloo_2x2")},
                 cli_profile=cli_out["profile"]["k1_launches"],
                 viewer_preview=viewer_out["preview_cornell"]["launches"],
                 viewer_run=viewer_out["run"]["launches"]),
             max_abs_err=k1_out["max_abs_err"],
             render=times(k1_out["render"],
                          prof_out["k1_render_kernel_device_ms"]),
             registers=k1_out["registers"],
             **times(k1_out, prof_out["k1_kernel_device_ms"])),
        dict(name="bvhw", route="cuda",
             source="pathtracer_tpu_torch/csrc/bvhw.cu",
             replaces="pathtracer_tpu/accel/bvhw.py:596",
             launches=box_out["launches"],
             max_abs_err=max(k2_out["max_abs_err_t"],
                             k2_out["max_abs_err_b"]),
             launches_by_path=dict(
                 box_main=box_out["launches"],
                 materials_main=mat_out["launches"],
                 classroom_main=class_out["launches"],
                 sponza_main=sponza_out["launches"],
                 sponza_main_table=sponza_out["k2_launches_main"],
                 sponza_alpha_table=sponza_out["k2_launches_alpha"],
                 mitsuba_main=feature_out["launches"],
                 lighttrace_config_b=lt_out["config_b"]["launches"],
                 sharded_b_gloo_2_config_b=sharded_out[
                     "b_gloo_2_config_b"]["launches_sum"][1],
                 viewer_preview_config_b=viewer_out["preview_config_b"][
                     "launches"]),
             bounce=times(k2_out["bounce"],
                          prof_out["k2_bounce_kernel_device_ms"]),
             alpha_table=times(sponza_gold["k2_alpha"],
                               prof_out["k2_alpha_kernel_device_ms"]),
             **times(k2_out, prof_out["k2_kernel_device_ms"]))]
    tex_cases = tex_out["cases"]
    tex_ms = prof_out["texture_kernel_device_ms"]
    tex_src = "pathtracer_tpu_torch/csrc/texture.cu"
    for kernel, key, replaces, main_case, runs in (
            ("texture_eval", "K3", "pathtracer_tpu/ops/bsdf.py:245",
             "classroom_width", dict(
                 classroom_main=class_out, sponza_main=sponza_out,
                 mitsuba_main=feature_out,
                 lighttrace_cornell=lt_out["cornell"],
                 lighttrace_config_b=lt_out["config_b"])),
            ("alpha_cut", "K4", "pathtracer_tpu/integrator.py:314",
             "cut_sponza_render", dict(sponza_main=sponza_out))):
        mine = {case: times(c, tex_ms[case]) for case, c in tex_cases.items()
                if case.startswith("cut_") == (key == "K4")}
        kernels.append(dict(
            name=f"{kernel} ({key})", route="cuda", source=tex_src,
            replaces=replaces,
            launches=runs[next(iter(runs))]["texture_launches"][kernel],
            launches_by_path={path: out["texture_launches"][kernel]
                              for path, out in runs.items()},
            max_abs_err=max(tex_cases[case]["max_abs_err"]
                            for case in mine),
            cases=mine, **times(tex_cases[main_case], tex_ms[main_case])))
    bsdf_ms = prof_out["bsdf_kernel_device_ms"]
    main_runs = dict(main=main_out, box_main=box_out,
                     **{f"materials_main_{config}": mat_out[config]
                        for config in MATERIAL_CONFIGS},
                     classroom_main=class_out, sponza_main=sponza_out,
                     mitsuba_main=feature_out,
                     **{f"samplers_main_{sampler}_{strategy}":
                        samplers_out[f"{sampler}_{strategy}"]
                        for sampler, strategy in SAMPLER_CONFIGS})
    for kind, key, plain in (("eval", "K5", "eval_f_pdf"),
                             ("sample", "K6", "sample_f")):
        mine = {case: times(c, bsdf_ms[case])
                for case, c in bsdf_out["cases"].items()
                if case.endswith(kind)}
        kernels.append(dict(
            name=f"bsdf_{kind} ({key})", route="cuda",
            source="pathtracer_tpu_torch/csrc/bsdf.cu",
            replaces=f"pathtracer_tpu/ops/bsdf.py {plain}",
            launches=main_out["bsdf_launches"][f"bsdf_{kind}"],
            launches_by_path={path: runs["bsdf_launches"][f"bsdf_{kind}"]
                              for path, runs in main_runs.items()},
            cases=mine, **mine[f"spheres_{kind}"]))
    sobol_ms = prof_out["sobol_kernel_device_ms"]
    kernels.append(dict(
        name="sobol_index, sobol_draw (K7)", route="cuda",
        source="pathtracer_tpu_torch/csrc/sobol.cu",
        replaces="pathtracer_tpu/ops/sobol.py sobol_index, "
                 "sobol_sample_dim, sobol_sample_dim2 (XLA, not Pallas)",
        launches=main_out["sobol_launches"],
        launches_by_path={path: runs["sobol_launches"]
                          for path, runs in main_runs.items()},
        cases={case: dict(times(c, sobol_ms[case]),
                          plain_device_ms=sobol_ms[f"plain_{case}"])
               for case, c in sobol_out["cases"].items()},
        **times(sobol_out["cases"]["dim2"], sobol_ms["dim2"])))
    kernels.append(dict(
        name="env_eval, env_sample (K8)", route="cuda",
        source="pathtracer_tpu_torch/csrc/env.cu",
        replaces="pathtracer_tpu/ops/lights.py env_le, env_pdf_li, "
                 "_env_sample_li (XLA, not Pallas)",
        launches=env_out["tankfarm"]["launches"],
        launches_by_path={path: runs["env_launches"]
                          for path, runs in main_runs.items()},
        cases={case: dict(times(c, c["device_ms"]),
                          plain_device_ms=c["plain_device_ms"])
               for case, c in env_out["cases"].items()},
        **times(env_out["cases"]["sample"],
                env_out["cases"]["sample"]["device_ms"])))
    for pid, kernel, line in (("P1", "gather_rows", 65),
                              ("P2", "gather_rows", 78),
                              ("P3", "gather_cols", 92),
                              ("P4", "gather_rows_warp", 107),
                              ("P5", "stack_push_read", 130)):
        kernels.append(dict(
            name=f"{kernel} ({pid})", route="cuda", source=probe_src,
            replaces=f"{probe_tool}:{line}",
            launches=probe_out["launches"][kernel],
            max_abs_err=probe_out["probes"][pid]["max_abs_err"],
            floor_device_ms=prof_out["probe_floor_device_ms"][pid],
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
            launches=probe2_out["launches"][kernel],
            max_abs_err=probe2_out["probes"][pid]["max_abs_err"],
            floor_device_ms=prof_out["probe_floor_device_ms"][pid],
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
