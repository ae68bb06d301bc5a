"""glTF 2.0 scene importer (JSON, binary buffers, GLB), host numpy.

Port of ``pathtracer_tpu/scene/gltf.py``: the camera search with
accumulated TRS transforms and its default look-at camera, the material
map (transmission 1 -> glass, alpha blend -> glass of eta 1.33, metallic
1 with roughness 0 -> mirror, else Disney), emissive meshes as
per-triangle area lights, KHR_lights_punctual directional, point and spot
(as point) lights, and the optional HDR environment (``default_lights``).
PNG and JPEG base-colour, metallic-roughness and normal textures load
into the texture pool; an alphaMode MASK material's base-colour alpha
becomes the mesh's alpha mask. The reference's quirks are kept, each
with the reference line that has it. ``load_gltf`` builds the scene on
``device``.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from ..core.camera import Camera
from ..utils.image import decode_image_bytes, read_hdr, read_jpeg, read_png
from ..utils.logging import get_logger
from .meshgen import transform_mesh
from .scene import (MAT_DISNEY, MAT_GLASS, MAT_MATTE, MAT_MIRROR,
                    SceneBuilder)

log = get_logger("scene")

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

EMISSIVE_SCALING_FACTOR = 10.0
DEFAULT_Z_NEAR, DEFAULT_Z_FAR = 0.01, 1000.0

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                     "data")


class GLTFFile:
    """A parsed .gltf or .glb: its JSON document and its buffers (the GLB
    BIN chunk, data URIs, or files beside it)."""

    def __init__(self, path: str):
        self.dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            blob = f.read()
        self.json = None
        self.bin = None
        if blob[:4] == b"glTF":  # GLB container
            off = 12
            while off < len(blob):
                clen, ctype = struct.unpack("<II", blob[off:off + 8])
                data = blob[off + 8:off + 8 + clen]
                if ctype == 0x4E4F534A:  # JSON
                    self.json = json.loads(data)
                elif ctype == 0x004E4942:  # BIN
                    self.bin = data
                off += 8 + clen
        else:
            self.json = json.loads(blob)
        self._buffers: dict[int, bytes] = {}

    def buffer(self, idx: int) -> bytes:
        if idx not in self._buffers:
            uri = self.json["buffers"][idx].get("uri")
            if uri is None:
                data = self.bin
            elif uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(self.dir, uri), "rb") as f:
                    data = f.read()
            self._buffers[idx] = data
        return self._buffers[idx]

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.json["accessors"][idx]
        count = acc["count"]
        ncomp = _TYPE_COUNT[acc["type"]]
        dtype = _COMPONENT_DTYPE[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp
        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype)
        else:
            bv = self.json["bufferViews"][acc["bufferView"]]
            data = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize)
            if stride == itemsize:
                out = np.frombuffer(
                    data, dtype, count * ncomp, start).reshape(count, ncomp)
            else:
                raw = np.frombuffer(data, np.uint8, count * stride,
                                    start).reshape(count, stride)
                out = raw[:, :itemsize].copy().view(dtype).reshape(count,
                                                                   ncomp)
        if acc.get("normalized") and dtype != np.float32:
            out = out.astype(np.float32) / np.iinfo(dtype).max
        return out


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    t = np.eye(4)
    if "translation" in node:
        t[:3, 3] = node["translation"]
    r = np.eye(4)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r[:3, :3] = _quat_to_mat(x, y, z, w)
    s = np.eye(4)
    if "scale" in node:
        s[0, 0], s[1, 1], s[2, 2] = node["scale"]
    return t @ r @ s


def _quat_to_mat(x, y, z, w):
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _load_texture_image(gf: GLTFFile, tex_index: int):
    """Decode a glTF texture's image (PNG or JPEG, by file path, data URI
    or bufferView) -> float array in [0, 1], or None for a format it
    cannot read (the caller falls back to the material's factors)."""
    try:
        tex = gf.json["textures"][tex_index]
        img = gf.json["images"][tex["source"]]
        if "uri" in img and not img["uri"].startswith("data:"):
            path = os.path.join(gf.dir, img["uri"])
            low = path.lower()
            if low.endswith(".png"):
                return read_png(path).astype(np.float32) / 255.0
            if low.endswith((".jpg", ".jpeg")):
                return read_jpeg(path).astype(np.float32) / 255.0
            return None
        if "uri" in img:  # data: URI
            blob = base64.b64decode(img["uri"].split(",", 1)[1])
            return decode_image_bytes(
                blob, img.get("mimeType", "")).astype(np.float32) / 255.0
        if "bufferView" in img:
            bv = gf.json["bufferViews"][img["bufferView"]]
            data = gf.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0)
            blob = data[start:start + bv["byteLength"]]
            return decode_image_bytes(
                blob, img.get("mimeType", "")).astype(np.float32) / 255.0
    except Exception:  # noqa: BLE001 - unreadable formats fall back
        log.warning("unsupported image format for texture %d", tex_index)
    return None


def _material_row(builder: SceneBuilder, mat: dict,
                  gf: GLTFFile | None = None) -> tuple[int, int]:
    """One glTF material -> (material row, alpha-mask texture descriptor
    or -1). The mask is the base-colour texture's alpha channel when
    alphaMode is MASK (alphaCutoff is ignored, as in the reference)."""
    pbr = mat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    # baseColorFactor sRGB-decoded in numpy
    # (pathtracer_tpu/scene/gltf.py:174-179)
    b3 = np.asarray(base[:3], np.float32)
    color = np.where(b3 <= 0.04045, b3 / 12.92,
                     np.power((b3 + 0.055) / 1.055, 2.4)).astype(np.float32)
    ext = mat.get("extensions", {})
    ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
    transmission = ext.get("KHR_materials_transmission", {}) \
        .get("transmissionFactor", 0.0)
    alpha_txd = -1
    if gf is not None and mat.get("alphaMode") == "MASK" \
            and "baseColorTexture" in pbr:
        img = _load_texture_image(gf, pbr["baseColorTexture"]["index"])
        if img is not None and img.shape[-1] == 4:
            alpha = np.repeat(img[..., 3:4], 3, axis=-1)
            alpha_txd = builder.add_texture_image(alpha)
    if transmission == 1.0:
        return builder.add_material(mtype=MAT_GLASS, kd=(1, 1, 1),
                                    ks=(1, 1, 1), eta=(ior,) * 3), alpha_txd
    alpha = base[3]
    if mat.get("alphaMode") == "BLEND" and alpha < 1.0:
        kt = 1.0 - alpha * color
        return builder.add_material(mtype=MAT_GLASS, kd=(1, 1, 1),
                                    ks=tuple(kt), eta=(1.33,) * 3), alpha_txd
    metallic = pbr.get("metallicFactor", 1.0)
    roughness = pbr.get("roughnessFactor", 1.0)
    if metallic == 1.0 and roughness == 0.0:
        return builder.add_material(mtype=MAT_MIRROR), alpha_txd
    kd_tx = metallic_tx = rough_tx = normal_tx = -1
    if gf is not None and "normalTexture" in mat:
        img = _load_texture_image(gf, mat["normalTexture"]["index"])
        if img is not None:
            normal_tx = builder.add_texture_image(img[..., :3])
    if gf is not None and "baseColorTexture" in pbr:
        img = _load_texture_image(gf, pbr["baseColorTexture"]["index"])
        if img is not None:
            # scaled by the (sRGB-decoded) colour factor
            kd_tx = builder.add_texture_image(
                img[..., :3], scale=tuple(color), srgb=True)
    if gf is not None and "metallicRoughnessTexture" in pbr:
        img = _load_texture_image(
            gf, pbr["metallicRoughnessTexture"]["index"])
        if img is not None:
            # channel split metallic = B, roughness = G
            # (pathtracer_tpu/scene/gltf.py:218-224)
            metallic_tx = builder.add_texture_image(
                img[..., :3], scale=(metallic,) * 3, channel=2)
            rough_tx = builder.add_texture_image(
                img[..., :3], scale=(roughness,) * 3, channel=1)
    return builder.add_material(
        mtype=MAT_DISNEY, kd=tuple(color),
        eta=(ior,) * 3, misc=(metallic, roughness, 0.0, 0.0),
        kd_tx=kd_tx, metallic_tx=metallic_tx, rough_tx=rough_tx,
        normal_tx=normal_tx), alpha_txd


def load_gltf(path: str, resolution=None, default_lights: bool = False,
              device="cuda"):
    """Parse a glTF / GLB scene -> (Camera, SceneData on ``device``,
    settings dict)."""
    gf = GLTFFile(path)
    doc = gf.json
    resolution = resolution or (640, 480)

    builder = SceneBuilder()
    # default material at slot 0; glTF material i is row i + 1
    builder.add_material(mtype=MAT_MATTE, kd=(0.5, 0.5, 0.5))
    alpha_by_mrow = {}
    for mat in doc.get("materials", []):
        mrow, a_txd = _material_row(builder, mat, gf)
        alpha_by_mrow[mrow] = a_txd

    cam_result = {}

    def visit(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        xf = parent @ _node_transform(node)
        if "camera" in node and "camera" not in cam_result:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                p = cam["perspective"]
                cam_result["camera"] = (xf, p.get("yfov", np.pi / 2),
                                        p.get("znear", DEFAULT_Z_NEAR),
                                        p.get("zfar", DEFAULT_Z_FAR))
        if "mesh" in node:
            for prim in doc["meshes"][node["mesh"]].get("primitives", []):
                if prim.get("mode", 4) != 4:
                    continue  # triangles only
                attrs = prim["attributes"]
                pos = gf.accessor(attrs["POSITION"]).astype(np.float32)
                idxs = gf.accessor(prim["indices"]).astype(np.int64) \
                    if "indices" in prim else \
                    np.arange(len(pos), dtype=np.int64)[:, None]
                idxs = idxs.reshape(-1, 3) if idxs.shape[-1] != 3 else idxs
                normals = gf.accessor(attrs["NORMAL"]).astype(np.float32) \
                    if "NORMAL" in attrs else None
                uvs = gf.accessor(attrs["TEXCOORD_0"]).astype(np.float32) \
                    if "TEXCOORD_0" in attrs else None
                pos_w, nrm_w = transform_mesh(pos, normals, xf)

                mat_idx = prim.get("material")
                mrow = 0 if mat_idx is None else mat_idx + 1
                emission = None
                if mat_idx is not None:
                    ef = doc["materials"][mat_idx].get(
                        "emissiveFactor", [0.0, 0.0, 0.0])
                    if any(v != 0.0 for v in ef):
                        # x10, and component [0] for all three channels
                        # (pathtracer_tpu/scene/gltf.py:283-286)
                        emission = np.full(
                            3, EMISSIVE_SCALING_FACTOR * ef[0], np.float32)
                builder.add_mesh(pos_w, idxs, nrm_w, uvs, mrow, emission,
                                 alpha_txd=alpha_by_mrow.get(mrow, -1))
        if "KHR_lights_punctual" in node.get("extensions", {}):
            li = node["extensions"]["KHR_lights_punctual"]["light"]
            light = doc["extensions"]["KHR_lights_punctual"]["lights"][li]
            color = light.get("color", [1, 1, 1])
            intensity = light.get("intensity", 1.0)
            # component [0] for all three channels
            # (pathtracer_tpu/scene/gltf.py:295-296)
            c = np.full(3, intensity * color[0], np.float32)
            if light.get("type") == "directional":
                builder.add_distant_light(
                    xf[:3, :3] @ np.array([0.0, 0.0, -1.0]), c)
            else:  # point, and spot as point
                builder.add_point_light(xf[:3, 3], c)
        for child in node.get("children", []):
            visit(child, xf)

    scene_idx = doc.get("scene", 0)
    for node_idx in doc.get("scenes", [{}])[scene_idx].get("nodes", []):
        visit(node_idx, np.eye(4))

    if default_lights:
        hdr = os.path.join(_DATA, "abandoned_tank_farm_04_1k.hdr")
        if os.path.exists(hdr):
            # environment z-up -> y-up: rotX(-pi/2)
            a = -np.pi / 2
            rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                           [0, np.sin(a), np.cos(a)]])
            builder.set_environment(read_hdr(hdr), rx)

    scene = builder.build(device=device)

    if "camera" in cam_result:
        xf, yfov, znear, zfar = cam_result["camera"]
        # the camera's rotation orthonormalised by SVD
        # (pathtracer_tpu/scene/gltf.py:323-330)
        u, _, vt = np.linalg.svd(xf[:3, :3])
        c2w = np.eye(4)
        c2w[:3, :3] = u @ vt
        c2w[:3, 3] = xf[:3, 3]
        camera = Camera.create(c2w, resolution[0] / resolution[1], yfov,
                               resolution, znear, zfar)
    else:
        # default camera: from the world bound's max corner toward the
        # origin (pathtracer_tpu/scene/gltf.py:333-338)
        p_max = scene.world_center.cpu().numpy() + \
            scene.world_radius.cpu().numpy()
        camera = Camera.look_at(
            p_max, [0, 0, 0], [0, 1, 0],
            (np.pi / 2) * (resolution[1] / resolution[0]), resolution,
            DEFAULT_Z_NEAR, DEFAULT_Z_FAR)
    return camera, scene, {}
