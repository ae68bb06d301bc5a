"""A Mitsuba 0.5 scene of diffuse shapes and area emitters, as triangles.

Reads what a Cornell-class scene holds: ``rectangle`` and ``cube``
shapes placed by a ``toWorld`` matrix, ``diffuse`` BSDFs (also inside
``twosided``) by reference, and ``area`` emitters of constant radiance
on a shape. Anything else is refused, so a scene this reference cannot
render never reaches a comparison.

The primitives are Mitsuba's unit shapes, meshed as pbrt-style triangle
meshes with per-vertex normals and no texture coordinates: the rectangle
is [-1, 1]^2 at z = 0 facing +z, split (0, 1, 2), (0, 2, 3); the cube is
[-1, 1]^3, a quad a face in the order +z, -z, +x, -x, +y, -y, each quad's
corners at (-1, -1), (1, -1), (1, 1), (-1, 1) along the face's (u, v)
axes and split as the rectangle. Positions go through the whole matrix
(divided by w) in double precision, normals through its linear part as
given; a shape with an emitter makes one area light a triangle, in the
order of the triangles.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

_CUBE_FACES = (  # (normal, u axis, v axis)
    ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
    ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
    ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
    ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
    ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
    ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
)
_QUAD = ((-1, -1), (1, -1), (1, 1), (-1, 1))
_SPLIT = ((0, 1, 2), (0, 2, 3))


def _quad_mesh(faces, offset: bool):
    """Quads at ``n`` (or through the origin) spanned by ``u`` and ``v``."""
    pos, nrm, tri = [], [], []
    for n, u, v in faces:
        n, u, v = (np.asarray(a, np.float64) for a in (n, u, v))
        base = len(pos)
        for a, b in _QUAD:
            pos.append((n if offset else 0.0) + a * u + b * v)
            nrm.append(n)
        tri += [[base + i for i in s] for s in _SPLIT]
    return np.asarray(pos), np.asarray(nrm), np.asarray(tri)


def rectangle():
    return _quad_mesh([((0, 0, 1), (1, 0, 0), (0, 1, 0))], offset=False)


def cube():
    return _quad_mesh(_CUBE_FACES, offset=True)


def _rgb(el, name: str) -> np.ndarray:
    for c in el.findall("rgb"):
        if c.get("name") == name:
            return np.asarray([float(x) for x in
                               c.get("value").replace(",", " ").split()],
                              np.float32)
    raise ValueError(f"no rgb {name!r} in <{el.tag} type="
                     f"{el.get('type')!r}>")


def _reflectance(bsdf) -> np.ndarray:
    kind = bsdf.get("type")
    if kind == "twosided":
        return _reflectance(bsdf.find("bsdf"))
    if kind != "diffuse":
        raise ValueError(f"the reference renders diffuse BSDFs, not {kind!r}")
    return _rgb(bsdf, "reflectance")


def load(path: str) -> dict:
    """The scene's triangles as float32 arrays: ``p`` (F, 3, 3), ``n``
    (F, 3, 3) vertex normals, ``kd`` (F, 3), ``emit`` (F, 3), ``light``
    (F,) the triangle's area-light number or -1, and ``light_tri`` (L,)
    each light's triangle."""
    root = ET.parse(path).getroot()
    kd_by_id = {b.get("id"): _reflectance(b) for b in root.findall("bsdf")}
    ps, ns, kds, emits, lit = [], [], [], [], []
    for shape in root.findall("shape"):
        kind = shape.get("type")
        if kind not in ("rectangle", "cube"):
            raise ValueError(f"the reference meshes rectangles and cubes, "
                             f"not {kind!r}")
        pos, nrm, tri = rectangle() if kind == "rectangle" else cube()
        m = np.eye(4)
        tr = shape.find("transform")
        if tr is not None:
            m = np.asarray([float(x) for x in
                            tr.find("matrix").get("value").split()],
                           np.float64).reshape(4, 4)
        ph = np.concatenate([pos, np.ones((len(pos), 1))], axis=1) @ m.T
        pos_w = (ph[:, :3] / ph[:, 3:4]).astype(np.float32)
        nrm_w = (nrm.astype(np.float32) @ m[:3, :3].T).astype(np.float32)
        ref = shape.find("ref")
        kd = kd_by_id[ref.get("id")] if ref is not None \
            else _reflectance(shape.find("bsdf"))
        emitter = shape.find("emitter")
        emit = np.zeros(3, np.float32)
        if emitter is not None:
            if emitter.get("type") != "area":
                raise ValueError("the reference renders area emitters only")
            emit = _rgb(emitter, "radiance")
        ps.append(pos_w[tri])
        ns.append(nrm_w[tri])
        kds.append(np.broadcast_to(kd, (len(tri), 3)))
        emits.append(np.broadcast_to(emit, (len(tri), 3)))
        lit.append(np.full(len(tri), emitter is not None))
    if root.findall("emitter"):
        raise ValueError("the reference renders no environment emitters")
    emit = np.concatenate(emits).astype(np.float32)
    is_light = np.concatenate(lit)
    light = np.where(is_light, np.cumsum(is_light) - 1, -1)
    return dict(p=np.concatenate(ps).astype(np.float32),
                n=np.concatenate(ns).astype(np.float32),
                kd=np.concatenate(kds).astype(np.float32), emit=emit,
                light=light.astype(np.int64),
                light_tri=np.flatnonzero(is_light).astype(np.int64))


def sensor_camera(path: str) -> dict:
    """The file's perspective sensor as the harness's camera numbers: the
    ``toWorld`` matrix turned by pi about its y axis (Mitsuba's camera
    looks down +z, this one down -z), its scale taken out; the vertical
    field of view from ``fov`` over the film's width."""
    sensor = ET.parse(path).getroot().find("sensor")
    floats = {f.get("name"): float(f.get("value"))
              for f in sensor.findall("float")}
    film = {i.get("name"): int(i.get("value"))
            for i in sensor.find("film").findall("integer")}
    m = np.asarray([float(x) for x in sensor.find("transform")
                    .find("matrix").get("value").split()]).reshape(4, 4)
    c2w = m @ np.diag([-1.0, 1.0, -1.0, 1.0])
    c2w[:3, :3] /= np.cbrt(abs(np.linalg.det(c2w[:3, :3])))
    return dict(cam_to_world=c2w.tolist(),
                fovy=float(np.radians(floats["fov"]) * film["height"]
                           / film["width"]))
