"""Mitsuba 0.5 XML scene importer (the elements the Cornell box uses).

Port of ``pathtracer_tpu/scene/mitsuba.py`` for diffuse / twosided BSDFs,
rectangle and cube shapes, area emitters and the perspective sensor.
Anything else raises NotImplementedError naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from ..core.camera import Camera
from . import meshgen
from .scene import MAT_MATTE, SceneBuilder, SceneData

_ITEM_9B = ("ROADMAP Queue 1 item 9b (Mitsuba import of the other "
            "BSDFs, textures, shapes and emitters)")


def _floats(el) -> dict[str, float]:
    return {c.get("name"): float(c.get("value")) for c in el.findall("float")}


def _integers(el) -> dict[str, int]:
    return {c.get("name"): int(c.get("value")) for c in el.findall("integer")}


def _rgbs(el) -> dict[str, np.ndarray]:
    out = {}
    for c in el.findall("rgb"):
        vals = [float(x) for x in c.get("value").replace(",", " ").split()]
        out[c.get("name")] = np.asarray(vals, np.float32)
    return out


def _matrix(el) -> np.ndarray:
    """<transform><matrix value="..."/></transform> -> (4,4) row-major."""
    vals = [float(x) for x in el.find("matrix").get("value").split()]
    return np.asarray(vals, np.float64).reshape(4, 4)


def _material_from_bsdf(scene_builder: SceneBuilder, el) -> int:
    """Map a Mitsuba BSDF element to a material-table row: twosided
    unwraps, diffuse -> Matte."""
    kind = el.get("type")
    if kind == "twosided":
        return _material_from_bsdf(scene_builder, el.find("bsdf"))
    if kind != "diffuse":
        raise NotImplementedError(f"bsdf type {kind!r}: {_ITEM_9B}")
    if el.find("texture") is not None:
        raise NotImplementedError(f"textured diffuse: {_ITEM_9B}")
    kd = _rgbs(el).get("reflectance", np.ones(3, np.float32))
    return scene_builder.add_material(mtype=MAT_MATTE, kd=kd)


# rotation fixing mitsuba's camera convention: post-rotate by pi about +y
_ROT_Y_PI = np.diag([-1.0, 1.0, -1.0, 1.0])


def _get_camera(sensor, resolution) -> Camera:
    if sensor.get("type") != "perspective":
        raise NotImplementedError(
            f"sensor type {sensor.get('type')!r}: only perspective")
    floats = _floats(sensor)
    film = sensor.find("film")
    fw = _integers(film)["width"] if film is not None else resolution[0]
    fh = _integers(film)["height"] if film is not None else resolution[1]
    fov = np.radians(floats["fov"])
    cam_to_world = _matrix(sensor.find("transform")) @ _ROT_Y_PI
    # normalize any scaling out of the rotation part
    r = cam_to_world[:3, :3]
    scale = np.cbrt(abs(np.linalg.det(r)))
    if scale > 0:
        cam_to_world = cam_to_world.copy()
        cam_to_world[:3, :3] = r / scale
    aspect = resolution[0] / resolution[1]
    return Camera.create(cam_to_world, aspect, fov * (fh / fw), resolution,
                         znear=0.01, zfar=10000.0)


def load_mitsuba(path: str, resolution=None, device="cuda"):
    """Parse a Mitsuba XML scene -> (Camera, SceneData on ``device``,
    settings dict with the scene's own max_depth / spp / film size)."""
    root = ET.parse(path).getroot()

    settings: dict = {}
    integrator = root.find("integrator")
    if integrator is not None:
        settings["max_depth"] = _integers(integrator).get("maxDepth")
    sensor = root.find("sensor")
    sampler = sensor.find("sampler") if sensor is not None else None
    if sampler is not None:
        settings["spp"] = _integers(sampler).get("sampleCount")
    film = sensor.find("film") if sensor is not None else None
    if film is not None:
        ints = _integers(film)
        settings["film"] = (ints.get("width"), ints.get("height"))
    if resolution is None:
        resolution = settings.get("film") or (640, 480)

    camera = _get_camera(sensor, resolution)

    scene_builder = SceneBuilder()
    materials_by_id = {
        bsdf.get("id"): _material_from_bsdf(scene_builder, bsdf)
        for bsdf in root.findall("bsdf")}

    for shape in root.findall("shape"):
        kind = shape.get("type")
        transform_el = shape.find("transform")
        matrix = _matrix(transform_el) if transform_el is not None \
            else np.eye(4)
        if kind == "rectangle":
            pos, idx, nrm, uv = meshgen.gen_rectangle()
        elif kind == "cube":
            pos, idx, nrm, uv = meshgen.gen_cube()
        else:
            raise NotImplementedError(f"shape type {kind!r}: {_ITEM_9B}")
        pos, nrm = meshgen.transform_mesh(pos, nrm, matrix)

        ref_el = shape.find("ref")
        bsdf_el = shape.find("bsdf")
        if ref_el is not None:
            mat_id = materials_by_id[ref_el.get("id")]
        elif bsdf_el is not None:
            mat_id = _material_from_bsdf(scene_builder, bsdf_el)
        else:
            raise ValueError("shape needs a material ref or inline bsdf")

        emission = None
        emitter = shape.find("emitter")
        if emitter is not None:
            if emitter.get("type") != "area":
                kind = emitter.get("type")
                raise NotImplementedError(
                    f"shape emitter {kind!r}: {_ITEM_9B}")
            emission = _rgbs(emitter)["radiance"]
        scene_builder.add_mesh(pos, idx, nrm, uv, mat_id, emission)

    for emitter in root.findall("emitter"):
        raise NotImplementedError(
            f"scene emitter {emitter.get('type')!r}: {_ITEM_9B}")

    scene: SceneData = scene_builder.build(device=device)
    return camera, scene, settings
