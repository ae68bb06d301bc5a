"""Procedural test and benchmark scenes (BASELINE.md's configurations).

Port of ``pathtracer_tpu/scene/procedural.py``: Config B (mirror and
glass spheres over a checkered ground, point and distant lights), Config
C (metal, substrate and glass microfacet spheres in a room under an area
light), Config D (Disney spheres under an HDR environment map) and the
Config E stand-in, ``box_field_scene`` (a BVH-heavy field of matte boxes,
~12 triangles per box; 48,012 at the default 4,000 boxes). Each returns
(camera, SceneData on ``device``).
"""

from __future__ import annotations

import os

import numpy as np

from ..core.camera import Camera
from ..utils.image import read_hdr
from . import meshgen
from .scene import (MAT_DISNEY, MAT_GLASS, MAT_MATTE, MAT_METAL, MAT_MIRROR,
                    MAT_SUBSTRATE, SceneBuilder)

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                     "data")


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


def _camera(resolution, half: float = 3.0) -> Camera:
    return Camera.look_at([0.0, half, 4.2 * half], [0.0, half * 0.8, 0.0],
                          [0, 1, 0], np.pi / 5, resolution)


def small_scene(resolution=(640, 480), device="cuda"):
    """Config B: mirror + glass spheres over an open checkered ground with
    point + directional lights (both always visible: an enclosed room
    would occlude the directional light)."""
    b = SceneBuilder()
    checker = b.add_texture_checker((0.725, 0.71, 0.68), (0.25, 0.25, 0.3),
                                    uv=(8, 8, 0, 0))
    ground = b.add_material(mtype=MAT_MATTE, kd_tx=checker)
    pos, idx, nrm, _ = meshgen.gen_rectangle()
    m = _plane_matrix([12, 0, 0], [0, 0, -12], [0, 0, 0])  # floor +y
    p, n = meshgen.transform_mesh(pos, nrm, m)
    b.add_mesh(p, idx, n,
               np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
               ground)
    mirror = b.add_material(mtype=MAT_MIRROR)
    glass = b.add_material(mtype=MAT_GLASS, kd=(1, 1, 1), ks=(1, 1, 1),
                           eta=(1.5, 1.5, 1.5))
    for center, radius, mat in [((-1.2, 1.0, 0.0), 1.0, mirror),
                                ((1.2, 1.0, 0.8), 1.0, glass)]:
        pos, idx, nrm, _ = meshgen.gen_sphere(center, radius, 24, 24)
        b.add_mesh(pos, idx, nrm, None, mat)
    b.add_point_light((0.0, 5.0, 2.0), (60.0, 60.0, 60.0))
    b.add_distant_light((-0.3, -1.0, -0.4), (1.5, 1.5, 1.4))
    return _camera(resolution), b.build(device=device)


def microfacet_scene(resolution=(640, 480), device="cuda"):
    """Config C: metal/glass/substrate microfacet spheres, area light."""
    b = SceneBuilder()
    _room(b)
    _ceiling_light(b)
    metal = b.add_material(
        mtype=MAT_METAL, ks=(1, 1, 1), eta=(0.2, 0.92, 1.1),
        k=(3.9, 2.45, 2.14), rough=(0.1, 0.25))
    substrate = b.add_material(
        mtype=MAT_SUBSTRATE, kd=(0.4, 0.2, 0.55), ks=(0.04, 0.04, 0.04),
        rough=(0.05, 0.05))
    glass = b.add_material(mtype=MAT_GLASS, kd=(1, 1, 1), ks=(1, 1, 1),
                           eta=(1.5, 1.5, 1.5))
    for center, mat in [((-1.8, 0.9, -0.5), metal),
                        ((0.0, 0.9, 0.5), substrate),
                        ((1.8, 0.9, -0.3), glass)]:
        pos, idx, nrm, _ = meshgen.gen_sphere(center, 0.9, 24, 24)
        b.add_mesh(pos, idx, nrm, None, mat)
    return _camera(resolution), b.build(device=device)


def envmap_disney_scene(resolution=(640, 480), device="cuda"):
    """Config D: HDR envmap lighting + Disney BSDF spheres."""
    b = SceneBuilder()
    floor = b.add_material(mtype=MAT_MATTE, kd=(0.6, 0.6, 0.6))
    pos, idx, nrm, _ = meshgen.gen_rectangle()
    m = np.asarray([[8, 0, 0, 0], [0, 0, -8, 0], [0, 8, 0, 0],
                    [0, 0, 0, 1]], np.float64)
    p, n = meshgen.transform_mesh(pos, nrm, m)
    b.add_mesh(p, idx, n, None, floor)
    for i, (metallic, rough) in enumerate(
            [(0.0, 0.8), (0.4, 0.4), (0.9, 0.15), (1.0, 0.05)]):
        mat = b.add_material(
            mtype=MAT_DISNEY, kd=(0.7, 0.25, 0.2), eta=(1.5, 0, 0),
            misc=(metallic, rough, 0.0, 0.0))
        pos, idx, nrm, _ = meshgen.gen_sphere(
            (-3.0 + 2.0 * i, 1.0, 0.0), 0.9, 24, 24)
        b.add_mesh(pos, idx, nrm, None, mat)
    hdr = read_hdr(os.path.join(_DATA, "abandoned_tank_farm_04_1k.hdr"))
    a = -np.pi / 2
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    b.set_environment(hdr, rx)
    cam = Camera.look_at([0, 2.5, 9.0], [0, 1.0, 0], [0, 1, 0],
                         np.pi / 5, resolution)
    return cam, b.build(device=device)


def box_field_scene(resolution=(1920, 1080), n_boxes: int = 4000,
                    seed: int = 0, device="cuda"):
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
