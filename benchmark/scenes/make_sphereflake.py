"""Write Eric Haines's sphereflake (the Standard Procedural Databases'
``balls.c``) as a glTF 2.0 file, deterministically.

    python3 benchmark/scenes/make_sphereflake.py [--size-factor 4] \
        [--out benchmark/scenes/sphereflake.gltf]

The recursion is SPD's: a base sphere of radius 0.5 at the origin, grown
along +z; each sphere of radius r, grown along ``dir``, buds nine tangent
children of radius r / 3 at ``centre + dir_k * (r + r / 3)``, six around
its equator and three above it, ``size_factor`` generations deep
(1 + 9 + ... + 9^size_factor spheres: 7,381 at size factor 4). A child
grows along its own ``dir_k``. The nine directions in the frame where
``dir`` is +z are ``create_objset``'s: the trio (1, 1, 0), (1, 0, -1),
(0, 1, -1) over sqrt(2), turned about (1, -1, 0) by asin(2 / sqrt(6)),
in three copies turned about z by 0, 120 and 240 degrees; that frame is
turned onto ``dir`` by the least rotation taking +z to it. A floor square
lies at z = -0.5, under the base sphere; three point lights sit at SPD's
positions; the camera is SPD's view, 45 degrees.

The file holds one unit sphere mesh, meshed as upstream pathtracer-rs
meshes a sphere (genmesh's ``SphereUv``, 10 segments and 10 rings, 180
triangles, unit normals, no texture coordinates), placed by one node a
sphere (``translation``, uniform ``scale``); a two-triangle floor mesh;
three ``KHR_lights_punctual`` point lights; a perspective camera. Its
buffer is embedded as a data URI. The materials are metallic-roughness,
which the glTF importer maps to its Disney BSDF.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

import numpy as np

SEGMENTS = RINGS = 10
BASE_RADIUS = 0.5
FLOOR_Z = -0.5
FLOOR_HALF = 6.0
EYE, AT, UP = (2.1, 1.3, 1.7), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)
FOV_DEG = 45.0
ASPECT = 640.0 / 480.0
ZNEAR, ZFAR = 0.01, 10000.0
LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
LIGHT_INTENSITY = 30.0
BALL = dict(baseColorFactor=[1.0, 0.9, 0.7, 1.0], metallicFactor=0.5,
            roughnessFactor=0.25)
FLOOR = dict(baseColorFactor=[1.0, 0.75, 0.33, 1.0], metallicFactor=0.0,
             roughnessFactor=1.0)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "sphereflake.gltf")


def unit_sphere():
    """(positions (100, 3) f32, normals, triangles (180, 3)) of the unit UV
    sphere: ring i at the polar angle pi i / 10 from +z, vertex j of a ring
    at the azimuth 2 pi j / 10, the direction in double precision rounded
    to float32; the quad (a, b, c, d) = ((i, j), (i, j + 1), (i + 1, j),
    (i + 1, j + 1)) split into (a, c, b) and (b, c, d), the first dropped
    on the top ring and the second on the bottom one."""
    theta = np.pi * np.arange(RINGS + 1) / RINGS
    phi = 2.0 * np.pi * np.arange(SEGMENTS) / SEGMENTS
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    dirs = np.stack([st * np.cos(phi), st * np.sin(phi),
                     np.broadcast_to(ct, (len(theta), len(phi)))], -1)
    dirs = dirs.reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(RINGS):
        for j in range(SEGMENTS):
            a, b = i * SEGMENTS + j, i * SEGMENTS + (j + 1) % SEGMENTS
            c, d = a + SEGMENTS, b + SEGMENTS
            if i > 0:
                tris.append((a, c, b))
            if i < RINGS - 1:
                tris.append((b, c, d))
    return dirs, dirs.copy(), np.asarray(tris, np.uint16)


def _axis_rotation(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def child_directions() -> np.ndarray:
    """(9, 3): the children's directions in the frame where the parent
    grows along +z (module text)."""
    s = 1.0 / np.sqrt(2.0)
    trio = np.array([[s, s, 0.0], [s, 0.0, -s], [0.0, s, -s]])
    trio = trio @ _axis_rotation((1.0, -1.0, 0.0),
                                 np.arcsin(2.0 / np.sqrt(6.0))).T
    return np.concatenate([
        trio @ _axis_rotation((0.0, 0.0, 1.0), k * 2.0 * np.pi / 3.0).T
        for k in range(3)])


def _onto(direction) -> np.ndarray:
    """The least rotation taking +z to the unit ``direction``."""
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(z, direction)
    s = np.linalg.norm(axis)
    if s < 1e-12:
        return np.eye(3) if direction[2] > 0 else np.diag([1.0, -1.0, -1.0])
    return _axis_rotation(axis, np.arctan2(s, float(np.dot(z, direction))))


def flake(size_factor: int) -> list:
    """[(centre (3,), radius)] of every sphere, parents before children,
    depth first."""
    kids = child_directions()
    out = []

    def grow(centre, radius, direction, depth):
        out.append((centre, radius))
        if depth == 0:
            return
        dirs = kids @ _onto(direction).T
        for d in dirs:
            grow(centre + d * (radius + radius / 3.0), radius / 3.0, d,
                 depth - 1)

    grow(np.zeros(3), BASE_RADIUS, np.array([0.0, 0.0, 1.0]), size_factor)
    return out


def camera_to_world() -> np.ndarray:
    """(4, 4) look-at of SPD's view: x right, y up, the camera looking
    down -z."""
    eye, at, up = (np.asarray(v, np.float64) for v in (EYE, AT, UP))
    back = (eye - at) / np.linalg.norm(eye - at)
    right = np.cross(up, back)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(back, right), \
        back, eye
    return m


def _floor():
    h, z = FLOOR_HALF, FLOOR_Z
    pos = np.array([[-h, -h, z], [h, -h, z], [h, h, z], [-h, h, z]],
                   np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    return pos, nrm, np.array([[0, 1, 2], [0, 2, 3]], np.uint16)


def gltf(size_factor: int) -> dict:
    """The glTF document of the sphereflake at ``size_factor``."""
    blob = bytearray()
    views, accessors = [], []

    def add(array: np.ndarray, kind: str, target: int) -> int:
        while len(blob) % 4:
            blob.append(0)
        data = np.ascontiguousarray(array).tobytes()
        views.append(dict(buffer=0, byteOffset=len(blob),
                          byteLength=len(data), target=target))
        blob.extend(data)
        acc = dict(bufferView=len(views) - 1, count=int(array.shape[0]),
                   componentType=5126 if array.dtype == np.float32 else 5123,
                   type=kind)
        if kind == "VEC3":
            acc.update(min=array.min(0).astype(float).tolist(),
                       max=array.max(0).astype(float).tolist())
        accessors.append(acc)
        return len(accessors) - 1

    meshes = []
    for (pos, nrm, tri), material in ((unit_sphere(), 0), (_floor(), 1)):
        p, n = add(pos, "VEC3", 34962), add(nrm, "VEC3", 34962)
        i = add(tri.reshape(-1), "SCALAR", 34963)
        meshes.append(dict(primitives=[dict(
            attributes=dict(POSITION=p, NORMAL=n), indices=i,
            material=material)]))
    nodes = [dict(mesh=0, translation=[float(v) for v in centre],
                  scale=[float(radius)] * 3)
             for centre, radius in flake(size_factor)]
    nodes.append(dict(mesh=1))
    for k, pos in enumerate(LIGHTS):
        nodes.append(dict(translation=list(pos), extensions=dict(
            KHR_lights_punctual=dict(light=k))))
    nodes.append(dict(camera=0, matrix=camera_to_world().T.reshape(-1)
                      .tolist()))
    uri = "data:application/octet-stream;base64," + \
        base64.b64encode(bytes(blob)).decode("ascii")
    return dict(
        asset=dict(version="2.0", generator="make_sphereflake.py"),
        extensionsUsed=["KHR_lights_punctual"],
        extensions=dict(KHR_lights_punctual=dict(lights=[
            dict(type="point", color=[1.0, 1.0, 1.0],
                 intensity=LIGHT_INTENSITY) for _ in LIGHTS])),
        scene=0, scenes=[dict(nodes=list(range(len(nodes))))],
        nodes=nodes, meshes=meshes,
        materials=[dict(name="ball", pbrMetallicRoughness=BALL),
                   dict(name="floor", pbrMetallicRoughness=FLOOR)],
        cameras=[dict(type="perspective", perspective=dict(
            yfov=float(np.radians(FOV_DEG)), aspectRatio=ASPECT,
            znear=ZNEAR, zfar=ZFAR))],
        buffers=[dict(byteLength=len(blob), uri=uri)],
        bufferViews=views, accessors=accessors)


def write(path: str, size_factor: int) -> str:
    """Write the file; returns its path."""
    text = json.dumps(gltf(size_factor), separators=(",", ":"))
    with open(path, "w") as fh:
        fh.write(text + "\n")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size-factor", type=int, default=4)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    print(write(args.out, args.size_factor))
    return 0


if __name__ == "__main__":
    sys.exit(main())
