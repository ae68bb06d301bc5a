"""Rank functions of the port's sharded-render tests: each runs in a
rank spawned by ``parallel.mesh.launch`` (one process a rank), so it
lives in a module that imports no JAX."""

import os

import torch

from pathtracer_tpu_torch.integrator import PathConfig
from pathtracer_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                                render_sharded)
from pathtracer_tpu_torch.scene import procedural
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

CORNELL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "cornell-box.xml")


def load(name: str, resolution, device):
    """(camera, SceneData) of "cornell" or "config_b" on ``device``."""
    if name == "cornell":
        cam, sd, _ = load_mitsuba(CORNELL, resolution=resolution,
                                  device=device)
        return cam, sd
    return procedural.small_scene(resolution, device=device)


def sharded_film(device, name, resolution, mesh, cfg: PathConfig, spp: int):
    """The rank's film of a sharded render of scene ``name``."""
    torch.set_num_threads(1)
    cam, sd = load(name, resolution, device)
    return render_sharded(cam, sd, mesh, cfg, spp=spp)


def sharded_errors(device):
    """The ValueErrors' messages of sharded renders that do not fit the
    group of 2 ranks: a mesh of 4, and spp 1 over 2 sample groups."""
    torch.set_num_threads(1)
    cam, sd = load("cornell", (8, 8), device)
    messages = []
    for mesh, spp in ((make_mesh(4), 2), (make_mesh_2d(1, 2), 1)):
        try:
            render_sharded(cam, sd, mesh, PathConfig(max_depth=1), spp=spp)
        except ValueError as err:
            messages.append(str(err))
    return messages
