"""Procedural benchmark scenes.

Port of ``pathtracer_tpu/scene/procedural.py`` for the Config E stand-in,
``box_field_scene``: a BVH-heavy field of matte boxes in a diffuse room
under one ceiling area light (~12 triangles per box; 48,012 at the
default 4,000 boxes). Configs B, C and D need mirror, glass, microfacet
and Disney materials, point and distant lights and environment maps:
ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import numpy as np

from pathtracer_tpu.scene import meshgen

from ..core.camera import Camera
from .scene import MAT_MATTE, SceneBuilder

_MORE_MATERIALS = "ROADMAP Queue 1 item 9 (full material and light set)"


def _plane_matrix(x_axis, y_axis, origin) -> np.ndarray:
    """Columns map the unit rectangle's local frame; local +z (the mesh
    normal) goes to normalize(x × y)."""
    x = np.asarray(x_axis, np.float64)
    y = np.asarray(y_axis, np.float64)
    z = np.cross(x, y)
    z = z / max(np.linalg.norm(z), 1e-12)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, origin
    return m


def _room(builder: SceneBuilder, half: float = 3.0):
    """A five-walled diffuse room (open toward the +z camera)."""
    white = builder.add_material(mtype=MAT_MATTE, kd=(0.73, 0.71, 0.68))
    red = builder.add_material(mtype=MAT_MATTE, kd=(0.63, 0.065, 0.05))
    green = builder.add_material(mtype=MAT_MATTE, kd=(0.14, 0.45, 0.091))
    pos, idx, nrm, _ = meshgen.gen_rectangle()
    s = half

    def wall(mat, m):
        p, n = meshgen.transform_mesh(pos, nrm, m)
        builder.add_mesh(p, idx, n, None, mat)

    # inward-facing normals
    wall(white, _plane_matrix([s, 0, 0], [0, 0, -s], [0, 0, 0]))      # floor +y
    wall(white, _plane_matrix([s, 0, 0], [0, 0, s], [0, 2 * s, 0]))   # ceil -y
    wall(white, _plane_matrix([s, 0, 0], [0, s, 0], [0, s, -s]))      # back +z
    wall(red, _plane_matrix([0, 0, -s], [0, s, 0], [-s, s, 0]))       # left +x
    wall(green, _plane_matrix([0, 0, s], [0, s, 0], [s, s, 0]))       # right -x
    return white


def _ceiling_light(builder: SceneBuilder, half: float = 3.0,
                   radiance=(17.0, 12.0, 4.0), size: float = 0.8):
    black = builder.add_material(mtype=MAT_MATTE, kd=(0, 0, 0))
    pos, idx, nrm, _ = meshgen.gen_rectangle()
    m = _plane_matrix([size, 0, 0], [0, 0, size],
                      [0, 2 * half - 1e-3, 0])  # normal -y (faces down)
    p, n = meshgen.transform_mesh(pos, nrm, m)
    builder.add_mesh(p, idx, n, None, black,
                     emission=np.asarray(radiance, np.float32))


def small_scene(resolution=(640, 480)):
    raise NotImplementedError(f"Config B (mirror, glass, point and distant "
                              f"lights, checker texture): {_MORE_MATERIALS}")


def microfacet_scene(resolution=(640, 480)):
    raise NotImplementedError(f"Config C (metal, substrate and glass "
                              f"microfacet materials): {_MORE_MATERIALS}")


def envmap_disney_scene(resolution=(640, 480)):
    raise NotImplementedError(f"Config D (environment map, Disney BSDF): "
                              f"{_MORE_MATERIALS}")


def box_field_scene(resolution=(1920, 1080), n_boxes: int = 4000,
                    seed: int = 0, device=None):
    """Config E stand-in: BVH-heavy field of boxes (~12*n_boxes tris).
    Returns (camera, SceneData on ``device``)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    _room(b, half=12.0)
    _ceiling_light(b, half=12.0, radiance=(60, 45, 18), size=4.0)
    mats = [
        b.add_material(mtype=MAT_MATTE,
                       kd=tuple(rng.uniform(0.2, 0.8, 3).tolist()))
        for _ in range(16)
    ]
    cube_pos, cube_idx, cube_nrm, _ = meshgen.gen_cube()
    all_pos, all_nrm, all_idx, all_mat = [], [], [], []
    vbase = 0
    for i in range(n_boxes):
        s = rng.uniform(0.05, 0.35)
        c = np.array([rng.uniform(-11, 11), rng.uniform(0.2, 10.0),
                      rng.uniform(-11, 11)])
        m = np.eye(4)
        m[:3, :3] *= s
        m[:3, 3] = c
        p, n = meshgen.transform_mesh(cube_pos, cube_nrm, m)
        all_pos.append(p)
        all_nrm.append(n)
        all_idx.append(cube_idx + vbase)
        vbase += len(p)
        all_mat.append(mats[i % len(mats)])
    pos = np.concatenate(all_pos)
    nrm = np.concatenate(all_nrm)
    idx = np.concatenate(all_idx)
    # one add_mesh call per material, in the reference's (set) order
    mat_per_tri = np.repeat(np.asarray(all_mat), 12)
    for mat in set(all_mat):
        sel = mat_per_tri == mat
        b.add_mesh(pos, idx[sel], nrm, None, mat)
    cam = Camera.look_at([0, 14.0, 30.0], [0, 5.0, 0], [0, 1, 0],
                         np.pi / 4, resolution)
    return cam, b.build(device=device)
