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
- ``graft_entry``: the port's twin of ``__graft_entry__.entry()``, one
  64x64, depth 3, 1 spp cornell band through ``render_band``.

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
import statistics
import subprocess
import sys
import time

import numpy as np
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
    return dict(leg=leg, card=smi, mrays_per_s=statistics.median(rates),
                mrays_per_s_min=min(rates), mrays_per_s_max=max(rates),
                renders=len(rates), rays=rays, seconds=seconds,
                ray_note=RAY_NOTE, **extra)


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


def leg_classroom(dev, smi: str) -> dict:
    from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                                 TracedScene)
    from pathtracer_tpu_torch.scene.gltf import load_gltf

    t0 = _sync()
    cam, sd, _ = load_gltf("data/classroom_proc.glb",
                           resolution=(1920, 1080), device=dev)
    t1 = _sync()
    scene = TracedScene.create(sd)
    t2 = _sync()
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode="onesample"),
                           spp=2)
    rays, seconds = [], []
    for _ in range(RENDERS):
        marks = []  # (host time, rays so far) after each chunk's sync

        def mark(_film, _done):
            marks.append((time.perf_counter(), integ.last_ray_count))

        integ.render_progressive(cam, scene, chunk_spp=1, callback=mark)
        (ta, ra), (tb, rb) = marks
        rays.append(rb - ra)
        seconds.append(tb - ta)
    return _rates("classroom", rays, seconds, smi, resolution=[1920, 1080],
                  spp=2, timed_spp=1, max_depth=5, mis_mode="onesample",
                  load_seconds=t1 - t0, create_seconds=t2 - t1,
                  triangles=int(sd.p0.shape[0]),
                  table_rows=int(scene.bw_rows.shape[0]))


def graft_entry(device="cuda"):
    """The port's twin of ``__graft_entry__.entry()``: (fn, args), where
    ``fn(*args)`` renders one Sobol-sampled row band covering the whole
    64x64 cornell box (depth 3, 1 spp) into the padded film ``args[1]``
    through ``render_band`` and returns (film_pad, rays, non-finite)."""
    from pathtracer_tpu_torch.core.film import film_pad_new, sample_bounds
    from pathtracer_tpu_torch.core.filter import filter_f1d
    from pathtracer_tpu_torch.integrator import (PathConfig, TracedScene,
                                                 render_band)
    from pathtracer_tpu_torch.ops import sobol as sb
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    res = (64, 64)
    cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=res,
                              device=device)
    scene = TracedScene.create(sd)
    cfg = PathConfig(max_depth=3)
    f1d, radius = filter_f1d()
    f1d = tuple(float(v) for v in f1d)
    (x0, y0), (x1, y1) = sample_bounds(*res, radius)
    ws, hs = x1 - x0, y1 - y0
    domain = sb.SobolDomain.create((x0, y0), (x1, y1), 1)
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1), indexing="xy")
    px, py = xs.ravel(), ys.ravel()
    scramble, b_base = sb.pixel_statics(domain, px, py)
    lo, hi, delta = sb.frame_statics(domain, 0)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def fn(scene_in, film_pad, px_in, py_in, b_in, scr_in):
        return render_band(
            scene_in, cfg, 1, (hs, ws), py_in < y1, film_pad, x0, y0, px_in,
            py_in, b_in, scr_in, [int(lo)], [int(hi)], [int(delta)],
            *sb.vdc_inv_rows(domain, device), *cam.ray_params(device), f1d,
            sb.sm32_device(device), float(np.float32(domain.resolution)),
            float(np.float32(domain.p_min[0])),
            float(np.float32(domain.p_min[1])), filter_radius=radius)

    args = (scene, film_pad_new(*res, extra_rows=hs, device=device),
            t(px, torch.int32), t(py, torch.int32),
            t(b_base.astype(np.int64), torch.int64),
            t(scramble.astype(np.int64), torch.int64))
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


LEGS = (leg_cornell, leg_box_field, leg_classroom, leg_graft_entry)


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
