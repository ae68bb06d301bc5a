#!/usr/bin/env python3
"""Benchmark of the PyTorch port on one CUDA card: one JSON line a leg.

Run from the repository root: ``python3 bench_torch.py``. Legs:

- ``cornell``: ``data/cornell-box.xml`` at 640x480, 16 spp, depth 5,
  "onesample" MIS (``bench.py``'s cornell leg): one warm-up render, then
  timed renders between ``torch.cuda.synchronize()`` calls,
  ``last_ray_count / dt``;
- ``box_field``: ``box_field_scene`` at 1920x1080, 4,000 boxes, 2 spp,
  depth 5, "onesample", timed the same way;
- ``classroom``: ``data/classroom_proc.glb`` at 1920x1080, depth 5,
  "onesample", 2 spp through ``render_progressive(chunk_spp=1)``: the
  first chunk is dropped and the second timed (``bench.py`` times Sponza
  so), once a render;
- ``sponza``: ``data/sponza_proc.glb`` (the alpha split: 1,320 masked
  triangles through their own BVH32 table, with re-spawn retries), the
  same way, with the retry loops' host syncs in each timed chunk;
- ``graft_entry``: the port's twin of ``__graft_entry__.entry()``, one
  64x64, depth 3, 1 spp cornell band through
  ``PathIntegrator.render_frames``;
- ``mitsuba_feature``: the Mitsuba feature scene of
  ``tests/torch_mitsuba_scenes.py`` (every BSDF, texture, shape and
  emitter arm of the importer; 392 triangles, K2) at 640x480, 16 spp,
  depth 5, "onesample", timed as cornell;
- ``cornell_stratified_all``: cornell as its leg, under the stratified
  sampler with the all-lights strategy;
- ``lighttrace_cornell``: ``LightTracer(PathConfig(max_depth=5))`` on
  cornell at 640x480 with the reference's 2^20 paths in waves of 2^16:
  one warm-up render, then timed renders, ``last_ray_count / dt``.

Each leg prints the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, the median, min and max Mrays/s of RENDERS timed renders, and the
set-up seconds. The ray count is the integrator's: live lanes a bounce
plus the shadow rays of every lane that shades, so it includes the lanes
whose query K1 or K2 skips (their t_max is 0). Without a CUDA card the
script raises; it has no CPU fallback.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

RENDERS = 3
RAY_NOTE = ("rays counted as the integrator counts them: live lanes a "
            "bounce plus shadow rays of every shading lane, including the "
            "lanes whose query K1 / K2 skips (t_max 0)")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _rates(leg: str, rays, seconds, smi: str, **extra) -> dict:
    rates = [r / s / 1e6 for r, s in zip(rays, seconds)]
    return dict(dict(leg=leg, card=smi, mrays_per_s=statistics.median(rates),
                     mrays_per_s_min=min(rates), mrays_per_s_max=max(rates),
                     renders=len(rates), rays=rays, seconds=seconds,
                     ray_note=RAY_NOTE), **extra)


def _sync() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def timed_renders(integ, cam, scene) -> tuple[list, list]:
    """One warm-up render, then RENDERS timed ones: (rays, seconds)."""
    integ.render(cam, scene)
    rays, seconds = [], []
    for _ in range(RENDERS):
        t0 = _sync()
        integ.render(cam, scene)
        seconds.append(_sync() - t0)
        rays.append(integ.last_ray_count)
    return rays, seconds


def leg_cornell(dev, smi: str) -> dict:
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    t0 = _sync()
    cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=(640, 480),
                              device=dev)
    scene = TracedScene.create(sd)
    setup = _sync() - t0
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=16)
    return _rates("cornell", *timed_renders(integ, cam, scene), smi,
                  resolution=[640, 480], spp=16, max_depth=5,
                  mis_mode="onesample", setup_seconds=setup)


def leg_cornell_stratified_all(dev, smi: str) -> dict:
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    t0 = _sync()
    cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=(640, 480),
                              device=dev)
    scene = TracedScene.create(sd)
    setup = _sync() - t0
    cfg = PathConfig(max_depth=5, mis_mode="onesample", sampler="stratified",
                     light_strategy="all")
    integ = PathIntegrator(cfg, spp=16)
    return _rates("cornell_stratified_all",
                  *timed_renders(integ, cam, scene), smi,
                  resolution=[640, 480], spp=16, max_depth=5,
                  mis_mode="onesample", sampler=cfg.sampler,
                  light_strategy=cfg.light_strategy, setup_seconds=setup)


def leg_mitsuba_feature(dev, smi: str) -> dict:
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_mitsuba_scenes

    with tempfile.TemporaryDirectory() as tmp:
        xml = torch_mitsuba_scenes.write_feature_scene(tmp)
        t0 = _sync()
        cam, sd, _ = load_mitsuba(xml, resolution=(640, 480), device=dev)
        t1 = _sync()
    scene = TracedScene.create(sd)
    t2 = _sync()
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=16)
    return _rates("mitsuba_feature", *timed_renders(integ, cam, scene), smi,
                  resolution=[640, 480], spp=16, max_depth=5,
                  mis_mode="onesample", triangles=int(sd.p0.shape[0]),
                  load_seconds=t1 - t0, create_seconds=t2 - t1)


def leg_lighttrace_cornell(dev, smi: str) -> dict:
    from pathtracer_tpu_torch.integrator import PathConfig, TracedScene
    from pathtracer_tpu_torch.integrator_lt import LightTracer
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    t0 = _sync()
    cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=(640, 480),
                              device=dev)
    scene = TracedScene.create(sd)
    setup = _sync() - t0
    tracer = LightTracer(PathConfig(max_depth=5), paths=1 << 20,
                         wave=1 << 16)
    return _rates("lighttrace_cornell", *timed_renders(tracer, cam, scene),
                  smi, resolution=[640, 480], paths=tracer.paths,
                  wave=tracer.wave, max_depth=5, setup_seconds=setup,
                  ray_note="rays as the reference's light tracer counts "
                  "them: paths x (2 max_depth + 1)")


def leg_box_field(dev, smi: str) -> dict:
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.procedural import box_field_scene

    t0 = _sync()
    cam, sd = box_field_scene((1920, 1080), n_boxes=4000, device=dev)
    scene = TracedScene.create(sd)
    setup = _sync() - t0
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=2)
    return _rates("box_field", *timed_renders(integ, cam, scene), smi,
                  resolution=[1920, 1080], n_boxes=4000, spp=2, max_depth=5,
                  mis_mode="onesample", setup_seconds=setup)


def _chunk_timed_leg(leg: str, path: str, dev, smi: str) -> dict:
    """A glTF scene at 1920x1080, depth 5, "onesample", 2 spp through
    ``render_progressive(chunk_spp=1)``: the first chunk dropped, the
    second timed, RENDERS times; set-up seconds and table sizes."""
    from pathtracer_tpu_torch import integrator as pint
    from pathtracer_tpu_torch.scene.gltf import load_gltf

    t0 = _sync()
    cam, sd, _ = load_gltf(path, resolution=(1920, 1080), device=dev)
    t1 = _sync()
    scene = pint.TracedScene.create(sd)
    t2 = _sync()
    integ = pint.PathIntegrator(
        pint.PathConfig(max_depth=5, mis_mode="onesample"), spp=2)
    rays, seconds, syncs = [], [], []
    for _ in range(RENDERS):
        marks = []  # (host time, rays so far, retry syncs) after each chunk

        def mark(_film, _done):
            marks.append((time.perf_counter(), integ.last_ray_count,
                          pint.RETRY_COUNTS["syncs"]))

        integ.render_progressive(cam, scene, chunk_spp=1, callback=mark)
        (ta, ra, sa), (tb, rb, sb) = marks
        rays.append(rb - ra)
        seconds.append(tb - ta)
        syncs.append(sb - sa)
    extra = {}
    if scene.has_alpha:
        extra = dict(n_opaque=scene.n_opaque,
                     alpha_table_rows=int(scene.bwa_rows.shape[0]),
                     retry_syncs_timed_chunk=syncs)
    return _rates(leg, rays, seconds, smi, resolution=[1920, 1080],
                  spp=2, timed_spp=1, max_depth=5, mis_mode="onesample",
                  load_seconds=t1 - t0, create_seconds=t2 - t1,
                  triangles=int(sd.p0.shape[0]),
                  table_rows=int(scene.bw_rows.shape[0]), **extra)


def leg_classroom(dev, smi: str) -> dict:
    return _chunk_timed_leg("classroom", "data/classroom_proc.glb", dev, smi)


def leg_sponza(dev, smi: str) -> dict:
    """Sponza, the reference's flagship leg (``bench.py:79-95``): its
    1,320 masked triangles through their own table, with re-spawns."""
    return _chunk_timed_leg("sponza", "data/sponza_proc.glb", dev, smi)


def graft_entry(device="cuda"):
    """The port's twin of ``__graft_entry__.entry()``: (fn, args), where
    ``fn(*args)`` renders one Sobol-sampled row band covering the whole
    64x64 cornell box (depth 3, 1 spp) into the padded film ``args[1]``
    through ``PathIntegrator.render_frames`` and returns (film_pad, rays,
    non-finite)."""
    from pathtracer_tpu_torch.core.film import film_pad_new
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    res = (64, 64)
    cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=res,
                              device=device)
    integ = PathIntegrator(PathConfig(max_depth=3), spp=1)
    su = integ.setup(cam, sd)

    def fn(su_in, film_pad, band_in):
        return integ.render_frames(su_in, film_pad, band_in, 0, 1)

    args = (su, film_pad_new(*res, extra_rows=su.hs, device=device),
            integ.band(su, su.y0, su.hs, su.y1))
    return fn, args


def leg_graft_entry(dev, smi: str) -> dict:
    t0 = _sync()
    fn, args = graft_entry(dev)
    setup = _sync() - t0
    fn(*args)  # warm-up
    rays, seconds = [], []
    for _ in range(RENDERS):
        t0 = _sync()
        _, n, _ = fn(*args)
        seconds.append(_sync() - t0)
        rays.append(float(n))
    return _rates("graft_entry", rays, seconds, smi, resolution=[64, 64],
                  spp=1, max_depth=3, mis_mode="ref", setup_seconds=setup)


LEGS = (leg_cornell, leg_box_field, leg_classroom, leg_sponza,
        leg_graft_entry, leg_mitsuba_feature, leg_cornell_stratified_all,
        leg_lighttrace_cornell)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py needs a CUDA card "
                           "(torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    smi = card()
    for leg in LEGS:
        print(json.dumps(leg(dev, smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
