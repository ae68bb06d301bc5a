"""Data-parallel rendering over a torch.distributed process group.

Port of ``pathtracer_tpu/parallel/mesh.py``. The reference shards the
frame's row bands (and, on a 2D mesh, the sample frames) over the devices
of one ``jax.sharding.Mesh`` and merges the films with one ``psum``. Here
each device is driven by a process of its own, and every process runs the
same program: rank r renders its band and frames into its own padded
film, and one ``all_reduce`` sums the films. A process a device, because
the render is host-bound: one Python thread issuing the ops of N devices
would feed them no faster than it feeds one.

Sobol seeding is by pixel position, so every sample is that of the
single-process render; only the order of the film's sums differs.

    launch(n, fn, *args, device="cuda")  # spawns n ranks, one a card
    # in each rank:
    film = render_sharded(camera, scene, make_mesh(n), cfg, spp)
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.film import film_crop, film_pad_new
from ..integrator import PathConfig, PathIntegrator


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical grid of ranks: ``shape`` maps each axis name to its
    size; rank r sits at the row-major position of r."""

    axis_names: tuple
    shape: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(n_devices: int | None = None) -> Mesh:
    """Row bands over ``n_devices`` ranks (default: every CUDA card)."""
    n = n_devices or torch.cuda.device_count()
    if n < 1:
        raise ValueError("make_mesh needs at least one device")
    return Mesh(axis_names=("tiles",), shape={"tiles": n})


def make_mesh_2d(n_tiles: int, n_samples: int) -> Mesh:
    """Row bands along ``tiles`` x sample frames along ``samples``. Both
    film contributions are additive, so the merge stays one all_reduce."""
    return Mesh(axis_names=("tiles", "samples"),
                shape={"tiles": n_tiles, "samples": n_samples})


def render_sharded(camera, scene, mesh: Mesh, cfg: PathConfig = PathConfig(),
                   spp: int = 4, filter_kind: str = "gaussian"):
    """Render the full frame data-parallel over ``mesh``; every rank
    returns the (H, W, 4) film on its scene's device.

    Call it in every rank of an initialised process group whose size is
    the mesh's. Rank r, at (tile i, sample group k), renders band i, the
    ``ceil(hs / n_tiles)`` rows from ``y0 + i * band`` (rows past the
    sample rectangle carry zero weight), and that band's frames
    ``[k * spp / S, (k + 1) * spp / S)``, in waves of at most WAVE_LANES
    lanes (``PathIntegrator.wave_rows``), into its own padded
    film; one ``all_reduce`` (SUM) of the padded films follows.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("render_sharded needs an initialised "
                         "torch.distributed process group (see launch)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"process group of {dist.get_world_size()} ranks "
                         f"for a mesh of {mesh.size}")
    integ = PathIntegrator(cfg, spp=spp, filter_kind=filter_kind)
    spp = integ.spp
    n_tiles = mesh.shape["tiles"]
    n_samp = mesh.shape.get("samples", 1)
    if spp % n_samp:
        raise ValueError(f"spp {spp} does not divide over "
                         f"{n_samp} sample groups")
    spp_local = spp // n_samp
    tile, group = divmod(dist.get_rank(), n_samp)

    su = integ.setup(camera, scene)
    w, h = camera.resolution
    band = -(-su.hs // n_tiles)
    wave_rows = integ.wave_rows(su.ws, band)
    by0 = su.y0 + tile * band
    y_stop = min(by0 + band, su.y1)
    film_pad = film_pad_new(w, h,
                            extra_rows=n_tiles * band - su.hs + wave_rows,
                            device=su.device)
    for wy0 in range(by0, by0 + band, wave_rows):
        film_pad, _rays, _bad = integ.render_frames(
            su, film_pad, integ.band(su, wy0, wave_rows, y_stop),
            group * spp_local, spp_local)
    dist.all_reduce(film_pad, op=dist.ReduceOp.SUM)
    return film_crop(film_pad, w, h)


def _rank_main(rank: int, n: int, fn, args, device: str, backend: str,
               tmpdir: str):
    # "cuda" puts rank r on card r; "cuda:K" and "cpu" name the device
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    # NCCL binds the rank to its card (its barrier asks which otherwise)
    dist.init_process_group(backend, init_method=f"file://{tmpdir}/store",
                            world_size=n, rank=rank,
                            device_id=dev if backend == "nccl" else None)
    try:
        result = fn(dev, *args)
        torch.save(result, os.path.join(tmpdir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(n: int, fn, *args, device: str = "cuda",
           backend: str | None = None) -> list:
    """Run ``fn(device, *args)`` in ``n`` spawned ranks of one process
    group and return their results, rank by rank (tensors in a result
    come back on the CPU through ``torch.save``).

    ``device`` "cuda" puts rank r on ``cuda:r``; "cuda:K" puts every rank
    on card K; "cpu" runs on the CPU. The ranks meet through a file store
    in a temporary directory, so concurrent launches never share a port.
    The backend is NCCL on the card and gloo on the CPU unless named
    (NCCL takes one rank a card)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch on the card: no CUDA device")
        last = n - 1 if dev.index is None else dev.index
        if last >= torch.cuda.device_count():
            raise ValueError(f"launch of {n} ranks on {device}: "
                             f"{torch.cuda.device_count()} cards")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    with tempfile.TemporaryDirectory() as tmpdir:
        mp.spawn(_rank_main, args=(n, fn, args, device, backend, tmpdir),
                 nprocs=n, join=True)
        # the results the ranks wrote with torch.save just now
        return [torch.load(os.path.join(tmpdir, f"result_{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
