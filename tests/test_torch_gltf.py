"""The port's glTF importer against the JAX package's.

``load_gltf`` is host numpy in both packages, so on both assets every
``SceneData`` leaf, every texture-pool leaf and the camera must be equal
(integer leaves exactly, float leaves ``np.array_equal``). The glTF cases
of ``tests/test_scene_io.py`` (material map, emissive area light, default
camera, JPEG texture) run again for the port, with a normal-map and an
alpha-mask material beside them. Classroom's ``TracedScene.create``
builds the reference's table; Sponza's alpha masks wait for ROADMAP
Queue 1 item 3.
"""

import base64
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import TracedScene as JTracedScene
from pathtracer_tpu.scene.gltf import load_gltf as jload_gltf
from pathtracer_tpu_torch.integrator import TracedScene
from pathtracer_tpu_torch.scene.gltf import load_gltf
from pathtracer_tpu_torch.scene.scene import (MAT_DISNEY, MAT_GLASS,
                                              MAT_MIRROR)
from pathtracer_tpu_torch.utils.image import write_png
from torch_leaves import assert_scene_equal

torch.set_num_threads(1)

ASSETS = {"classroom": "data/classroom_proc.glb",
          "sponza": "data/sponza_proc.glb"}


@pytest.mark.parametrize("name", sorted(ASSETS))
def test_load_gltf_matches_reference(name):
    cam, sd, settings = load_gltf(ASSETS[name], resolution=(96, 54),
                                  device="cpu")
    jcam, jsd, jsettings = jload_gltf(ASSETS[name], resolution=(96, 54))
    assert settings == jsettings == {}
    assert_scene_equal(sd, jsd)
    for f in dataclasses.fields(cam):
        np.testing.assert_array_equal(np.asarray(getattr(cam, f.name)),
                                      np.asarray(getattr(jcam, f.name)),
                                      err_msg=f.name)
    want = {"classroom": (22_696, 4, 0), "sponza": (123_592, 5, 1_320)}
    tris, pyramids, masked = want[name]
    assert sd.p0.shape[0] == tris
    assert sd.tex.n_levels.shape[0] == pyramids
    assert int((sd.tri_alpha_txd >= 0).sum()) == masked


def test_default_lights_environment_matches_reference():
    _, sd, _ = load_gltf(ASSETS["classroom"], resolution=(32, 18),
                         default_lights=True, device="cpu")
    _, jsd, _ = jload_gltf(ASSETS["classroom"], resolution=(32, 18),
                           default_lights=True)
    assert bool(sd.has_env)
    assert_scene_equal(sd, jsd)


def test_classroom_create_builds_the_reference_table():
    _, sd, _ = load_gltf(ASSETS["classroom"], resolution=(32, 18),
                         device="cpu")
    _, jsd, _ = jload_gltf(ASSETS["classroom"], resolution=(32, 18))
    ts = TracedScene.create(sd)
    jts = JTracedScene.create(jsd, use_pallas=False)
    assert ts.bw_rows.numpy().tobytes() == np.asarray(jts.bw_rows).tobytes()
    assert ts.bw_depth == jts.bw_depth
    assert_scene_equal(ts.data, jts.data)
    assert ts.has_tex and ts.image_tex and not ts.has_normal_maps
    # base-colour textures only
    assert ts.tex_channels == jts.tex_channels == (True, False, False, False)
    assert ts.has_normal_maps == jts.has_normal_maps


def test_sponza_create_names_item_3():
    _, sd, _ = load_gltf(ASSETS["sponza"], resolution=(32, 18),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="alpha masks.*item 3"):
        TracedScene.create(sd)


# --- the glTF cases of tests/test_scene_io.py, for the port


def _doc(materials, mesh_mat=0, uvs=False, extra=None):
    """A one-triangle glTF document with data-URI buffers."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2]], np.uint16)
    views = [pos.tobytes()] + ([uv.tobytes()] if uvs else []) \
        + [idx.tobytes()]
    blob, offsets = b"", []
    for v in views:
        offsets.append(len(blob))
        blob += v
    blob += b"\x00" * ((4 - len(blob) % 4) % 4)
    attrs = {"POSITION": 0}
    accessors = [{"bufferView": 0, "componentType": 5126, "count": 3,
                  "type": "VEC3"}]
    if uvs:
        attrs["TEXCOORD_0"] = 1
        accessors.append({"bufferView": 1, "componentType": 5126,
                          "count": 3, "type": "VEC2"})
    accessors.append({"bufferView": len(views) - 1, "componentType": 5123,
                      "count": 3, "type": "SCALAR"})
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": attrs, "indices": len(accessors) - 1,
            "material": mesh_mat}]}],
        "materials": materials, "accessors": accessors,
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": len(v)}
                        for o, v in zip(offsets, views)],
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}],
    }
    doc.update(extra or {})
    return doc


def _load_both(tmp_path, doc, **kw):
    path = os.path.join(str(tmp_path), "t.gltf")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    cam, sd, _ = load_gltf(path, device="cpu", **kw)
    jcam, jsd, _ = jload_gltf(path, **kw)
    assert_scene_equal(sd, jsd)
    return cam, sd, jcam


@pytest.mark.parametrize("mat_json,want", [
    ({"pbrMetallicRoughness": {"metallicFactor": 1.0,
                               "roughnessFactor": 0.0}}, MAT_MIRROR),
    ({"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.5, 0.5, 0.5]},
      "alphaMode": "BLEND"}, MAT_GLASS),
    ({"extensions": {"KHR_materials_transmission":
                     {"transmissionFactor": 1.0}}}, MAT_GLASS),
    ({"pbrMetallicRoughness": {"metallicFactor": 0.3,
                               "roughnessFactor": 0.4}}, MAT_DISNEY),
])
def test_gltf_material_map(tmp_path, mat_json, want):
    _, sd, _ = _load_both(tmp_path, _doc([mat_json]))
    # slot 0 is the default material; the mesh uses slot 1
    assert int(sd.mat_type[1]) == want
    assert int(sd.material_id[0]) == 1


def test_gltf_emissive_creates_area_light(tmp_path):
    mat = {"pbrMetallicRoughness": {}, "emissiveFactor": [0.5, 0.2, 0.1]}
    _, sd, _ = _load_both(tmp_path, _doc([mat]))
    assert int(sd.n_lights) == 1
    # x10, component [0] for all three channels
    np.testing.assert_allclose(sd.light_emit[0].numpy(), [5.0, 5.0, 5.0],
                               atol=1e-6)


def test_gltf_default_camera(tmp_path):
    cam, _, jcam = _load_both(tmp_path, _doc([{"pbrMetallicRoughness": {}}]),
                              resolution=(128, 96))
    assert cam.resolution == (128, 96)
    np.testing.assert_array_equal(cam.cam_to_world, jcam.cam_to_world)


def test_gltf_camera_node_and_punctual_lights(tmp_path):
    """A rotated, scaled camera node (the SVD orthonormalises it) and a
    directional and a point light, colour from component [0]."""
    lights = {"KHR_lights_punctual": {"lights": [
        {"type": "directional", "color": [0.9, 0.1, 0.1], "intensity": 2},
        {"type": "point", "color": [0.5, 1, 1], "intensity": 7}]}}
    doc = _doc([{"pbrMetallicRoughness": {}}], extra={
        "extensions": lights,
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.7, "znear": 0.05}}]})
    doc["scenes"][0]["nodes"] = [0, 1, 2, 3]
    doc["nodes"] += [
        {"camera": 0, "translation": [0, 0.5, 3],
         "rotation": [0.0, 0.2588190, 0.0, 0.9659258],
         "scale": [1.0, 1.0001, 1.0]},
        {"rotation": [-0.3826834, 0, 0, 0.9238795],
         "extensions": {"KHR_lights_punctual": {"light": 0}}},
        {"translation": [1, 2, 3],
         "extensions": {"KHR_lights_punctual": {"light": 1}}}]
    cam, sd, jcam = _load_both(tmp_path, doc, resolution=(40, 30))
    np.testing.assert_array_equal(cam.cam_to_world, jcam.cam_to_world)
    np.testing.assert_array_equal(cam.raster_to_camera,
                                  jcam.raster_to_camera)
    r = cam.cam_to_world[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)
    assert int(sd.n_lights) == 2
    np.testing.assert_allclose(sd.light_emit.numpy(),
                               [[1.8] * 3, [3.5] * 3], rtol=1e-6)


def _png_uri(tmp_path, pixels):
    path = os.path.join(str(tmp_path), "t.png")
    write_png(path, pixels)
    with open(path, "rb") as fh:
        return "data:image/png;base64," + base64.b64encode(
            fh.read()).decode()


def test_gltf_textures_normal_map_and_alpha_mask(tmp_path):
    """PNG base-colour (RGBA, alphaMode MASK), metallic-roughness and
    normal textures: the pool, the channel split (metallic B, roughness
    G), the sRGB flag and the alpha mask all as the reference builds
    them."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    mr = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
    nm = rng.integers(100, 256, (4, 4, 3), dtype=np.uint8)
    mat = {"pbrMetallicRoughness": {
        "baseColorFactor": [0.8, 0.6, 0.4, 1.0],
        "baseColorTexture": {"index": 0},
        "metallicFactor": 0.7, "roughnessFactor": 0.9,
        "metallicRoughnessTexture": {"index": 1}},
        "normalTexture": {"index": 2}, "alphaMode": "MASK"}
    doc = _doc([mat], uvs=True, extra={
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": [{"uri": _png_uri(tmp_path, px)}
                   for px in (base, mr, nm)]})
    _, sd, _ = _load_both(tmp_path, doc)
    assert int(sd.mat_kd_tx[1]) >= 0 and int(sd.mat_normal_tx[1]) >= 0
    assert int(sd.txd_channel[sd.mat_metallic_tx[1]]) == 2
    assert int(sd.txd_channel[sd.mat_rough_tx[1]]) == 1
    assert bool(sd.txd_srgb[sd.mat_kd_tx[1]])
    assert int(sd.tri_alpha_txd[0]) >= 0
    # five pyramids: alpha, normal, base colour, metallic, roughness
    assert sd.tex.n_levels.shape[0] == 5
    with pytest.raises(NotImplementedError, match="item 3"):
        TracedScene.create(sd)


def test_gltf_jpeg_texture(tmp_path):
    """A JPEG base-colour texture loads into the pool (Pillow, imported
    when a JPEG is read)."""
    pil = pytest.importorskip("PIL.Image")
    img = np.zeros((16, 16, 3), np.uint8)
    img[:8, :8] = [255, 0, 0]
    img[8:, 8:] = [255, 0, 0]
    img[:8, 8:] = [0, 0, 255]
    img[8:, :8] = [0, 0, 255]
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, format="JPEG", quality=95)
    uri = "data:image/jpeg;base64," + base64.b64encode(
        buf.getvalue()).decode()
    doc = _doc([{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
               uvs=True, extra={"textures": [{"source": 0}],
                                "images": [{"uri": uri}]})
    _, sd, _ = _load_both(tmp_path, doc)
    txd = int(sd.mat_kd_tx[1])
    assert txd >= 0
    img_id = int(sd.txd_image[txd])
    base = int(sd.tex.level_offset[img_id, 0])
    w0, h0 = int(sd.tex.level_w[img_id, 0]), int(sd.tex.level_h[img_id, 0])
    texels = sd.tex.data[base:base + w0 * h0].reshape(h0, w0, 3).numpy()
    assert texels[2, 2, 0] > 0.5 and texels[2, 2, 2] < 0.3  # red corner


def test_gltf_unreadable_image_falls_back_to_factors(tmp_path):
    doc = _doc([{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
               uvs=True, extra={"textures": [{"source": 0}],
                                "images": [{"uri": "data:image/gif;base64,"
                                            + base64.b64encode(
                                                b"GIF89a..").decode()}]})
    _, sd, _ = _load_both(tmp_path, doc)
    assert int(sd.mat_kd_tx[1]) == -1
