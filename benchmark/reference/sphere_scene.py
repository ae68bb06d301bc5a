"""A Mitsuba 0.5 scene of rectangles, cubes and spheres under area
emitters, with diffuse, rough conductor, rough plastic and smooth
dielectric BSDFs, as triangles with a material row each.

The rectangle and the cube are ``mitsuba_scene``'s unit shapes placed by
their ``toWorld`` matrix. A ``sphere`` is placed by its ``center`` point
and ``radius`` alone (a ``toWorld`` on it is refused) and meshed as the
upstream importer meshes it, a UV sphere of 10 segments and 10 rings
(genmesh's ``SphereUv``): vertex ring ``i`` = 0..10 at the polar angle
``pi i / 10`` from +z, vertex ``j`` = 0..9 of a ring at the azimuth
``2 pi j / 10``, the vertex at ``centre + radius * dir`` with the unit
``dir`` as its normal (the directions in double precision, rounded to
float32, then scaled and moved in float32). Between rings ``i`` and
``i + 1`` the quad of segment ``j`` over the corners a = (i, j),
b = (i, j + 1), c = (i + 1, j), d = (i + 1, j + 1) (``j + 1`` taken
modulo 10) is split into (a, c, b) and (b, c, d), each kept unless two
of its corners are a pole's: 180 triangles a sphere.

The BSDFs and the parameters read (each required where no default is
named; any other BSDF or shape is refused):

- ``diffuse`` (also inside ``twosided``): ``reflectance`` -> MATTE, kd;
- ``roughconductor``: ``alpha``, ``eta``, ``k``, ``specular_reflectance``
  (default 1) -> METAL: Trowbridge-Reitz reflection with the conductor's
  Fresnel term, ks the reflectance;
- ``roughplastic``: ``alpha``, ``diffuse_reflectance``, ``int_ior`` ->
  SUBSTRATE: Ashikhmin-Shirley's FresnelBlend, kd the diffuse
  reflectance, ks Schlick's r0 = ((ior - 1) / (ior + 1))^2;
- ``dielectric``: ``int_ior`` -> GLASS: specular reflection and
  transmission into the interior ``eta``, kd = ks = 1.

An alpha below 0.001 is raised to it.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from . import mitsuba_scene

MATTE, METAL, SUBSTRATE, GLASS = 0, 1, 2, 3
SPHERE_SEGMENTS = SPHERE_RINGS = 10
MIN_ALPHA = 0.001


def sphere(center, radius: float):
    """(positions, normals, triangles) of the UV sphere (module text), in
    world space, float32."""
    theta = np.pi * np.arange(SPHERE_RINGS + 1) / SPHERE_RINGS
    phi = 2.0 * np.pi * np.arange(SPHERE_SEGMENTS) / SPHERE_SEGMENTS
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    dirs = np.stack([st * np.cos(phi), st * np.sin(phi),
                     np.broadcast_to(ct, (len(theta), len(phi)))], -1)
    dirs = dirs.reshape(-1, 3).astype(np.float32)
    pos = np.asarray(center, np.float32) + np.float32(radius) * dirs
    tris = []
    for i in range(SPHERE_RINGS):
        for j in range(SPHERE_SEGMENTS):
            a = i * SPHERE_SEGMENTS + j
            b = i * SPHERE_SEGMENTS + (j + 1) % SPHERE_SEGMENTS
            c = a + SPHERE_SEGMENTS
            d = b + SPHERE_SEGMENTS
            if i > 0:  # a and b are not the north pole's
                tris.append((a, c, b))
            if i < SPHERE_RINGS - 1:  # c and d are not the south pole's
                tris.append((b, c, d))
    return pos, dirs, np.asarray(tris, np.int64)


def _values(el, tag: str) -> dict:
    return {c.get("name"): c.get("value") for c in el.findall(tag)}


def _need(table: dict, name: str, el):
    if name not in table:
        raise ValueError(f"<bsdf type={el.get('type')!r}> lacks {name!r}")
    return table[name]


def _rgb(value: str) -> np.ndarray:
    return np.asarray([float(x) for x in value.replace(",", " ").split()],
                      np.float32)


def material(el) -> dict:
    """The material row of a <bsdf> element: mtype, kd, ks, eta (3), k,
    alpha."""
    kind = el.get("type")
    if kind == "twosided":
        return material(el.find("bsdf"))
    floats, rgbs = _values(el, "float"), _values(el, "rgb")
    one = np.ones(3, np.float32)
    row = dict(mtype=MATTE, kd=np.zeros(3, np.float32),
               ks=np.zeros(3, np.float32), eta=one, k=np.zeros(3, np.float32),
               alpha=np.float32(MIN_ALPHA))
    if kind == "diffuse":
        row.update(kd=_rgb(_need(rgbs, "reflectance", el)))
    elif kind == "roughconductor":
        row.update(mtype=METAL, eta=_rgb(_need(rgbs, "eta", el)),
                   k=_rgb(_need(rgbs, "k", el)),
                   ks=_rgb(rgbs["specular_reflectance"])
                   if "specular_reflectance" in rgbs else one,
                   alpha=np.float32(float(_need(floats, "alpha", el))))
    elif kind == "roughplastic":
        ior = float(_need(floats, "int_ior", el))
        r0 = (ior - 1.0) ** 2 / (ior + 1.0) ** 2
        row.update(mtype=SUBSTRATE,
                   kd=_rgb(_need(rgbs, "diffuse_reflectance", el)),
                   ks=np.full(3, r0, np.float32),
                   alpha=np.float32(float(_need(floats, "alpha", el))))
    elif kind == "dielectric":
        ior = float(_need(floats, "int_ior", el))
        row.update(mtype=GLASS, kd=one, ks=one,
                   eta=np.full(3, ior, np.float32))
    else:
        raise ValueError(f"the reference renders diffuse, roughconductor, "
                         f"roughplastic and dielectric BSDFs, not {kind!r}")
    row["alpha"] = np.float32(max(row["alpha"], np.float32(MIN_ALPHA)))
    return row


def _placed(shape):
    """(positions, normals, triangles) of a shape in world space."""
    kind = shape.get("type")
    tr = shape.find("transform")
    if kind == "sphere":
        if tr is not None:
            raise ValueError("the reference places a sphere by its centre "
                             "and radius alone")
        pt = shape.find("point")
        return sphere([float(pt.get(a)) for a in "xyz"],
                      float(_values(shape, "float")["radius"]))
    if kind not in ("rectangle", "cube"):
        raise ValueError(f"the reference meshes rectangles, cubes and "
                         f"spheres, not {kind!r}")
    pos, nrm, tri = mitsuba_scene.rectangle() if kind == "rectangle" \
        else mitsuba_scene.cube()
    m = np.eye(4)
    if tr is not None:
        m = np.asarray([float(x) for x in
                        tr.find("matrix").get("value").split()],
                       np.float64).reshape(4, 4)
    ph = np.concatenate([pos, np.ones((len(pos), 1))], axis=1) @ m.T
    pos_w = (ph[:, :3] / ph[:, 3:4]).astype(np.float32)
    nrm_w = (nrm.astype(np.float32) @ m[:3, :3].T).astype(np.float32)
    return pos_w, nrm_w, tri


def load(path: str) -> dict:
    """The scene's triangles as float32 arrays: ``p`` (F, 3, 3), ``n`` (F,
    3, 3) vertex normals, ``emit`` (F, 3), ``light`` (F,) the triangle's
    area-light number or -1, ``light_tri`` (L,) each light's triangle, and
    the material rows by triangle: ``mtype`` (F,) int64, ``kd``, ``ks``,
    ``eta``, ``k`` (F, 3), ``alpha`` (F,)."""
    root = ET.parse(path).getroot()
    by_id = {b.get("id"): material(b) for b in root.findall("bsdf")}
    out = {k: [] for k in ("p", "n", "emit", "lit", "mtype", "kd", "ks",
                           "eta", "k", "alpha")}
    for shape in root.findall("shape"):
        pos, nrm, tri = _placed(shape)
        ref = shape.find("ref")
        row = by_id[ref.get("id")] if ref is not None \
            else material(shape.find("bsdf"))
        emitter = shape.find("emitter")
        emit = np.zeros(3, np.float32)
        if emitter is not None:
            if emitter.get("type") != "area":
                raise ValueError("the reference renders area emitters only")
            emit = _rgb(_values(emitter, "rgb")["radiance"])
        f = len(tri)
        out["p"].append(pos[tri])
        out["n"].append(nrm[tri])
        out["emit"].append(np.broadcast_to(emit, (f, 3)))
        out["lit"].append(np.full(f, emitter is not None))
        out["mtype"].append(np.full(f, row["mtype"], np.int64))
        out["alpha"].append(np.full(f, row["alpha"], np.float32))
        for key in ("kd", "ks", "eta", "k"):
            out[key].append(np.broadcast_to(row[key], (f, 3)))
    if root.findall("emitter"):
        raise ValueError("the reference renders no environment emitters")
    cat = {k: np.concatenate(v) for k, v in out.items()}
    is_light = cat.pop("lit")
    light = np.where(is_light, np.cumsum(is_light) - 1, -1)
    tris = {k: v.astype(np.float32) for k, v in cat.items()
            if k not in ("mtype",)}
    tris.update(mtype=cat["mtype"], light=light.astype(np.int64),
                light_tri=np.flatnonzero(is_light).astype(np.int64))
    return tris
