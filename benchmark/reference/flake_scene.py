"""A glTF 2.0 scene of instanced triangle meshes with metallic-roughness
materials under point lights (``scenes/sphereflake.gltf``), read into
world-space triangles, each node's instance kept apart.

The reader takes what such a file holds and refuses the rest: a JSON
document whose buffers are data URIs; nodes with ``translation``,
``scale`` or ``matrix`` (no ``rotation``), a ``mesh``, a ``camera``, a
``KHR_lights_punctual`` light or ``children``; triangle primitives with
``POSITION``, ``NORMAL`` and ``indices`` and a material; point lights.

A node's transform is T S (glTF's T R S with R the identity; ``matrix``
where given) times its parent's, in double precision. Its mesh goes to
world space as the importers of the JAX package and of pathtracer-rs
place a glTF mesh (``shape.rs:592-623``): each position, extended by
w = 1 in float32, times the transposed matrix in double precision, over
its w, rounded to float32; each normal times the transposed linear part,
not normalised, rounded to float32. The primitive's triangles follow in
the order of its index list.

A material's ``baseColorFactor`` is sRGB-decoded in float32 (value / 12.92
at or below 0.04045, else ((value + 0.055) / 1.055)^2.4); ``metallicFactor``
and ``roughnessFactor`` default to 1, the index of refraction to 1.5 (no
``KHR_materials_ior``). Every material here is the importers' Disney
branch: neither transmissive, blended nor a perfect mirror (metallic 1 and
roughness 0), which the reader refuses. A point light's radiant intensity
is ``intensity`` times the first colour component, on all three channels
(the importers' reading), at its node's world position.
"""

from __future__ import annotations

import base64
import json

import numpy as np

_DTYPE = {5121: np.uint8, 5123: np.uint16, 5125: np.uint32,
          5126: np.float32}
_WIDTH = {"SCALAR": 1, "VEC3": 3}


class _Doc:
    def __init__(self, path: str):
        with open(path) as fh:
            self.json = json.load(fh)
        self.buffers = []
        for buf in self.json["buffers"]:
            uri = buf.get("uri", "")
            if not uri.startswith("data:"):
                raise ValueError("the reader takes data-URI buffers only")
            self.buffers.append(base64.b64decode(uri.split(",", 1)[1]))

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.json["accessors"][idx]
        view = self.json["bufferViews"][acc["bufferView"]]
        if "byteStride" in view:
            raise ValueError("the reader takes tightly packed views only")
        dtype = _DTYPE[acc["componentType"]]
        width = _WIDTH[acc["type"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        return np.frombuffer(self.buffers[view["buffer"]], dtype,
                             acc["count"] * width, start) \
            .reshape(acc["count"], width)


def node_matrix(node: dict) -> np.ndarray:
    """(4, 4) float64 local transform of a node: its ``matrix``, else
    T S (a ``rotation`` is refused)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    if "rotation" in node:
        raise ValueError("the reader takes no node rotation")
    t, s = np.eye(4), np.eye(4)
    if "translation" in node:
        t[:3, 3] = node["translation"]
    if "scale" in node:
        s[0, 0], s[1, 1], s[2, 2] = node["scale"]
    return t @ s


def srgb_decode(rgb) -> np.ndarray:
    b = np.asarray(rgb, np.float32)
    return np.where(b <= 0.04045, b / 12.92,
                    np.power((b + 0.055) / 1.055, 2.4)).astype(np.float32)


def material(mat: dict) -> dict:
    """The Disney row of a glTF material: kd (3,), metallic, roughness,
    eta."""
    pbr = mat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    metallic = pbr.get("metallicFactor", 1.0)
    roughness = pbr.get("roughnessFactor", 1.0)
    ext = mat.get("extensions", {})
    if ext or mat.get("alphaMode", "OPAQUE") != "OPAQUE" or \
            (metallic == 1.0 and roughness == 0.0) or any(
                k in pbr for k in ("baseColorTexture",
                                   "metallicRoughnessTexture")):
        raise ValueError("the reader takes untextured opaque Disney "
                         "materials only")
    return dict(kd=srgb_decode(base[:3]), metallic=np.float32(metallic),
                roughness=np.float32(roughness), eta=np.float32(1.5))


def placed(pos: np.ndarray, nrm: np.ndarray, m: np.ndarray):
    """A mesh's positions and normals in world space (module text)."""
    ph = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], -1)
    pw = ph @ m.T
    return ((pw[:, :3] / pw[:, 3:4]).astype(np.float32),
            (nrm @ m[:3, :3].T).astype(np.float32))


def load(path: str) -> dict:
    """The scene as float32 arrays: ``p``, ``n`` (F, 3, 3) triangle
    corners and vertex normals in world space, in node order; per
    triangle its material's ``kd`` (F, 3), ``metallic``, ``roughness``,
    ``eta`` (F,); ``inst_first``, ``inst_count`` (I,) each mesh node's
    triangles; ``light_p``, ``light_i`` (L, 3) the point lights' positions
    and intensities; ``camera``, the first camera's world matrix (4, 4)
    and ``yfov`` (or None)."""
    doc = _Doc(path)
    js = doc.json
    mats = [material(m) for m in js.get("materials", [])]
    lights = js.get("extensions", {}).get("KHR_lights_punctual", {}) \
        .get("lights", [])
    out = {k: [] for k in ("p", "n", "kd", "metallic", "roughness", "eta")}
    first, count, light_p, light_i = [], [], [], []
    camera = []
    n_tri = 0

    def visit(idx: int, parent: np.ndarray):
        nonlocal n_tri
        node = js["nodes"][idx]
        xf = parent @ node_matrix(node)
        if "camera" in node and not camera:
            cam = js["cameras"][node["camera"]]
            camera.append((xf, cam["perspective"]["yfov"]))
        if "mesh" in node:
            start = n_tri
            for prim in js["meshes"][node["mesh"]]["primitives"]:
                if prim.get("mode", 4) != 4 or "material" not in prim:
                    raise ValueError("the reader takes triangle primitives "
                                     "with a material only")
                attrs = prim["attributes"]
                pos = doc.accessor(attrs["POSITION"]).astype(np.float32)
                nrm = doc.accessor(attrs["NORMAL"]).astype(np.float32)
                tri = doc.accessor(prim["indices"]).astype(np.int64) \
                    .reshape(-1, 3)
                pos_w, nrm_w = placed(pos, nrm, xf)
                row = mats[prim["material"]]
                f = len(tri)
                out["p"].append(pos_w[tri])
                out["n"].append(nrm_w[tri])
                out["kd"].append(np.broadcast_to(row["kd"], (f, 3)))
                for key in ("metallic", "roughness", "eta"):
                    out[key].append(np.full(f, row[key], np.float32))
                n_tri += f
            first.append(start)
            count.append(n_tri - start)
        ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if ext is not None:
            light = lights[ext["light"]]
            if light.get("type") != "point":
                raise ValueError("the reader takes point lights only")
            light_p.append(xf[:3, 3])
            light_i.append(np.full(3, light.get("intensity", 1.0)
                                   * light.get("color", [1, 1, 1])[0]))
        for child in node.get("children", []):
            visit(child, xf)

    scene = js["scenes"][js.get("scene", 0)]
    for idx in scene["nodes"]:
        visit(idx, np.eye(4))
    tris = {k: np.ascontiguousarray(np.concatenate(v)).astype(np.float32)
            for k, v in out.items()}
    tris.update(inst_first=np.asarray(first, np.int64),
                inst_count=np.asarray(count, np.int64),
                light_p=np.asarray(light_p, np.float32).reshape(-1, 3),
                light_i=np.asarray(light_i, np.float32).reshape(-1, 3),
                camera=camera[0] if camera else None)
    return tris
