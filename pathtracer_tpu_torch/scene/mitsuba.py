"""Mitsuba 0.5 XML scene importer.

Port of ``pathtracer_tpu/scene/mitsuba.py``: the perspective sensor; the
diffuse (constant, checkerboard or bitmap PNG), conductor, rough
conductor, dielectric, rough dielectric, plastic and rough plastic
BSDFs; rectangle, cube, sphere and OBJ shapes with area emitters; the
envmap and sunsky scene emitters. Paths in the file are relative to its
directory. An unknown BSDF or shape raises ValueError; a shape emitter
other than ``area`` and an unknown scene emitter are ignored, as in the
reference.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..core.camera import Camera
from ..utils.image import read_hdr, read_png
from . import meshgen
from .scene import (MAT_GLASS, MAT_MATTE, MAT_METAL, MAT_MIRROR,
                    MAT_ROUGHGLASS, MAT_SUBSTRATE, SceneBuilder, SceneData)

# the sunsky emitter's stand-in: the reference falls back to this map
SUNSKY_HDR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", "data", "abandoned_tank_farm_04_1k.hdr")


def _floats(el) -> dict[str, float]:
    return {c.get("name"): float(c.get("value")) for c in el.findall("float")}


def _integers(el) -> dict[str, int]:
    return {c.get("name"): int(c.get("value")) for c in el.findall("integer")}


def _strings(el) -> dict[str, str]:
    return {c.get("name"): c.get("value") for c in el.findall("string")}


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


def schlick_r0_from_eta(eta: float) -> float:
    return (eta - 1.0) ** 2 / (eta + 1.0) ** 2


def _texture_from_el(scene_builder: SceneBuilder, el,
                     scene_dir: str = ".") -> int:
    """A nested <texture> as a descriptor id, or -1: checkerboard with its
    UV scale and offset; bitmap (PNG only) with the v-flip UV map
    (1, -1, 0, 0) and sRGB decode. A missing or non-PNG bitmap gives -1."""
    tex = el.find("texture")
    if tex is None:
        return -1
    kind = tex.get("type")
    if kind == "checkerboard":
        rgbs = _rgbs(tex)
        floats = _floats(tex)
        return scene_builder.add_texture_checker(
            rgbs.get("color0", np.zeros(3, np.float32)),
            rgbs.get("color1", np.ones(3, np.float32)),
            uv=(floats.get("uscale", 1.0), floats.get("vscale", 1.0),
                floats.get("uoffset", 0.0), floats.get("voffset", 0.0)))
    if kind == "bitmap":
        fname = _strings(tex)["filename"]
        path = os.path.join(scene_dir, fname)
        if fname.lower().endswith(".png") and os.path.exists(path):
            img = read_png(path).astype(np.float32)[..., :3] / 255.0
            return scene_builder.add_texture_image(
                img, uv=(1.0, -1.0, 0.0, 0.0), srgb=True)
    return -1


def _material_from_bsdf(scene_builder: SceneBuilder, el,
                        scene_dir: str = ".") -> int:
    """Map a Mitsuba BSDF element to a material-table row: twosided
    unwraps; diffuse -> Matte, conductor (material none) -> Mirror,
    (rough)conductor -> Metal, dielectric -> Glass, roughdielectric ->
    RoughGlass, (rough)plastic -> Substrate with Schlick's r0."""
    kind = el.get("type")
    if kind == "twosided":
        return _material_from_bsdf(scene_builder, el.find("bsdf"), scene_dir)
    rgbs = _rgbs(el)
    floats = _floats(el)
    strings = _strings(el)
    if kind == "diffuse":
        kd = rgbs.get("reflectance", np.ones(3, np.float32))
        return scene_builder.add_material(
            mtype=MAT_MATTE, kd=kd,
            kd_tx=_texture_from_el(scene_builder, el, scene_dir))
    if kind in ("conductor", "roughconductor"):
        if strings.get("material") == "none":
            return scene_builder.add_material(mtype=MAT_MIRROR)
        alpha = floats.get("alpha", 0.001)
        return scene_builder.add_material(
            mtype=MAT_METAL,
            eta=rgbs.get("eta", np.full(3, 0.2, np.float32)),
            k=rgbs.get("k", np.full(3, 3.9, np.float32)),
            ks=rgbs.get("specular_reflectance", np.ones(3, np.float32)),
            rough=(alpha, alpha), remap=False)
    if kind == "dielectric":
        ior = floats.get("int_ior", 1.5)
        return scene_builder.add_material(
            mtype=MAT_GLASS, kd=np.ones(3, np.float32),
            ks=np.ones(3, np.float32), eta=(ior, ior, ior))
    if kind == "roughdielectric":
        # the reference's own arm (Mitsuba's importer has none): glossy
        # glass through the RoughGlass material
        ior = floats.get("int_ior", 1.5)
        alpha = floats.get("alpha", 0.1)
        return scene_builder.add_material(
            mtype=MAT_ROUGHGLASS, kd=np.ones(3, np.float32),
            ks=np.ones(3, np.float32), eta=(ior, ior, ior),
            rough=(alpha, alpha), remap=False)
    if kind in ("plastic", "roughplastic"):
        alpha = floats.get("alpha", 0.001) if kind == "roughplastic" else 0.001
        r0 = schlick_r0_from_eta(floats.get("int_ior", 1.49))
        return scene_builder.add_material(
            mtype=MAT_SUBSTRATE,
            kd=rgbs.get("diffuse_reflectance", np.full(3, 0.5, np.float32)),
            ks=np.full(3, r0, np.float32),
            rough=(alpha, alpha), remap=False)
    raise ValueError(f"unsupported bsdf type: {kind}")


# rotation fixing mitsuba's camera convention: post-rotate by pi about +y
_ROT_Y_PI = np.diag([-1.0, 1.0, -1.0, 1.0])


def _env_light_to_world() -> np.ndarray:
    """The environment's orientation fix: Euler (-pi/2, -pi/2, 0), i.e.
    Ry(-pi/2) Rx(-pi/2), then a z flip."""
    a, b = -np.pi / 2, -np.pi / 2
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    m = np.eye(4)
    m[:3, :3] = (ry @ rx) @ np.diag([1.0, 1.0, -1.0])
    return m


def _get_camera(sensor, resolution) -> Camera:
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


def _shape_mesh(shape, scene_dir: str):
    """(positions, indices, normals, uvs) of a <shape> in world space."""
    kind = shape.get("type")
    transform_el = shape.find("transform")
    matrix = _matrix(transform_el) if transform_el is not None else np.eye(4)
    if kind == "rectangle":
        pos, idx, nrm, uv = meshgen.gen_rectangle()
    elif kind == "cube":
        pos, idx, nrm, uv = meshgen.gen_cube()
    elif kind == "sphere":
        center = np.zeros(3)
        pt = shape.find("point")
        if pt is not None:
            center = np.array([float(pt.get(a)) for a in "xyz"])
        pos, idx, nrm, uv = meshgen.gen_sphere(
            center, _floats(shape).get("radius", 1.0))
        matrix = np.eye(4)  # placed by its centre and radius alone
    elif kind == "obj":
        pos, idx, nrm, uv = meshgen.load_obj(
            os.path.join(scene_dir, _strings(shape)["filename"]))
        booleans = {c.get("name"): c.get("value")
                    for c in shape.findall("boolean")}
        if booleans.get("faceNormals") == "true":
            nrm = None  # the vertex normals are disregarded
    else:
        raise ValueError(f"unsupported shape type: {kind}")
    pos, nrm = meshgen.transform_mesh(pos, nrm, matrix)
    return pos, idx, nrm, uv


def load_mitsuba(path: str, resolution=None, device="cuda"):
    """Parse a Mitsuba XML scene -> (Camera, SceneData on ``device``,
    settings dict with the scene's own max_depth / spp / film size)."""
    root = ET.parse(path).getroot()
    scene_dir = os.path.dirname(os.path.abspath(path))

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
        bsdf.get("id"): _material_from_bsdf(scene_builder, bsdf, scene_dir)
        for bsdf in root.findall("bsdf")}

    for shape in root.findall("shape"):
        pos, idx, nrm, uv = _shape_mesh(shape, scene_dir)
        ref_el = shape.find("ref")
        bsdf_el = shape.find("bsdf")
        if ref_el is not None:
            mat_id = materials_by_id[ref_el.get("id")]
        elif bsdf_el is not None:
            mat_id = _material_from_bsdf(scene_builder, bsdf_el, scene_dir)
        else:
            raise ValueError("shape needs a material ref or inline bsdf")

        emission = None
        emitter = shape.find("emitter")
        if emitter is not None and emitter.get("type") == "area":
            emission = _rgbs(emitter)["radiance"]
        scene_builder.add_mesh(pos, idx, nrm, uv, mat_id, emission)

    for emitter in root.findall("emitter"):
        kind = emitter.get("type")
        if kind == "envmap":
            img = read_hdr(os.path.join(scene_dir,
                                        _strings(emitter)["filename"]))
            transform_el = emitter.find("transform")
            to_world = _matrix(transform_el) if transform_el is not None \
                else np.eye(4)
            scene_builder.set_environment(
                img, (to_world @ _env_light_to_world())[:3, :3])
        elif kind == "sunsky" and os.path.exists(SUNSKY_HDR):
            # the reference renders no sky model: its default map stands in
            scene_builder.set_environment(read_hdr(SUNSKY_HDR),
                                          _env_light_to_world()[:3, :3])

    scene: SceneData = scene_builder.build(device=device)
    return camera, scene, settings
