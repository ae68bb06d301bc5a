"""Mitsuba scene files for the importer's tests and the card's phases:
cornell's walls and area light with other BSDFs, textures, shapes and
emitters. Imports neither JAX nor the JAX package, so the card tests and
``chip_smoke.py`` can use it where JAX is absent.

``write_feature_scene(dirpath)`` writes the feature scene: a dielectric
and a rough-conductor sphere, a mirror cube (conductor, material
``none``), a rough-plastic floor (with a checkerboard, which the
importer ignores outside the diffuse BSDF, as the reference does), a
checkerboard left wall, a back wall with a bitmap (a PNG written beside
the file), an OBJ (written beside it too) with ``faceNormals`` and a
rough dielectric, and an envmap with a transform. ``scene_xml`` wraps
other elements in the same room.
"""

import os

import numpy as np

from pathtracer_tpu_torch.utils.image import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDR = os.path.join(ROOT, "data", "abandoned_tank_farm_04_1k.hdr")

_HEAD = """<?xml version="1.0" encoding="utf-8"?>
<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="8"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="19.5"/>
    <transform name="toWorld">
      <matrix value="-1 0 0 0 0 1 0 1 0 0 -1 6.8 0 0 0 1"/>
    </transform>
    <sampler type="sobol"><integer name="sampleCount" value="16"/></sampler>
    <film type="ldrfilm">
      <integer name="width" value="64"/><integer name="height" value="64"/>
    </film>
  </sensor>
"""

_WALL_BSDFS = """
  <bsdf type="twosided" id="LeftWall"><bsdf type="diffuse">
    <rgb name="reflectance" value="0.63, 0.065, 0.05"/></bsdf></bsdf>
  <bsdf type="twosided" id="RightWall"><bsdf type="diffuse">
    <rgb name="reflectance" value="0.14, 0.45, 0.091"/></bsdf></bsdf>
  <bsdf type="twosided" id="Floor"><bsdf type="diffuse">
    <rgb name="reflectance" value="0.725, 0.71, 0.68"/></bsdf></bsdf>
  <bsdf type="twosided" id="Ceiling"><bsdf type="diffuse">
    <rgb name="reflectance" value="0.725, 0.71, 0.68"/></bsdf></bsdf>
  <bsdf type="twosided" id="BackWall"><bsdf type="diffuse">
    <rgb name="reflectance" value="0.725, 0.71, 0.68"/></bsdf></bsdf>
  <bsdf type="twosided" id="Light"><bsdf type="diffuse">
    <rgb name="reflectance" value="0, 0, 0"/></bsdf></bsdf>
"""

# cornell's five walls and its light (data/cornell-box.xml)
_WALLS = """
  <shape type="rectangle"><transform name="toWorld"><matrix value="-4.37114e-008 1 4.37114e-008 0 0 -8.74228e-008 2 0 1 4.37114e-008 1.91069e-015 0 0 0 0 1"/></transform><ref id="{floor}"/></shape>
  <shape type="rectangle"><transform name="toWorld"><matrix value="-1 7.64274e-015 -1.74846e-007 0 8.74228e-008 8.74228e-008 -2 2 0 -1 -4.37114e-008 0 0 0 0 1"/></transform><ref id="Ceiling"/></shape>
  <shape type="rectangle"><transform name="toWorld"><matrix value="1.91069e-015 1 1.31134e-007 0 1 3.82137e-015 -8.74228e-008 1 -4.37114e-008 1.31134e-007 -2 -1 0 0 0 1"/></transform><ref id="{back}"/></shape>
  <shape type="rectangle"><transform name="toWorld"><matrix value="4.37114e-008 -1.74846e-007 2 1 1 3.82137e-015 -8.74228e-008 1 3.82137e-015 1 2.18557e-007 0 0 0 0 1"/></transform><ref id="RightWall"/></shape>
  <shape type="rectangle"><transform name="toWorld"><matrix value="-4.37114e-008 8.74228e-008 -2 -1 1 3.82137e-015 -8.74228e-008 1 0 -1 -4.37114e-008 0 0 0 0 1"/></transform><ref id="{left}"/></shape>
  <shape type="rectangle"><transform name="toWorld"><matrix value="0.235 -1.66103e-008 -7.80685e-009 -0.005 -2.05444e-008 3.90343e-009 -0.0893 1.98 2.05444e-008 0.19 8.30516e-009 -0.03 0 0 0 1"/></transform><ref id="Light"/>
    <emitter type="area"><rgb name="radiance" value="17, 12, 4"/></emitter></shape>
"""


def scene_xml(bsdfs: str = "", shapes: str = "", emitters: str = "",
              floor: str = "Floor", back: str = "BackWall",
              left: str = "LeftWall") -> str:
    """Cornell's room (walls, light, camera) with extra ``bsdfs``,
    ``shapes`` and scene ``emitters`` (XML text); ``floor``, ``back`` and
    ``left`` name the BSDF ids of the floor, the back and the left wall."""
    return (_HEAD + _WALL_BSDFS + bsdfs
            + _WALLS.format(floor=floor, back=back, left=left) + shapes
            + emitters + "</scene>\n")


def write_octahedron_obj(path: str) -> None:
    """A unit octahedron with one normal and one uv a vertex (so only
    ``faceNormals`` drops the normals)."""
    v = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
         (0, 0, -1)]
    faces = [(0, 2, 4), (4, 2, 1), (1, 2, 5), (5, 2, 0), (0, 4, 3),
             (4, 1, 3), (1, 5, 3), (5, 0, 3)]
    lines = [f"v {x} {y} {z}" for x, y, z in v]
    lines += [f"vn {x} {y} {z}" for x, y, z in v]
    lines += [f"vt {0.5 + 0.5 * x} {0.5 + 0.5 * y}" for x, y, _ in v]
    lines += [f"f {a + 1}/{a + 1}/{a + 1} {b + 1}/{b + 1}/{b + 1} "
              f"{c + 1}/{c + 1}/{c + 1}" for a, b, c in faces]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_picture_png(path: str, size: int = 16) -> None:
    """A small RGB test picture: gradients in red and green, blue bars."""
    y, x = np.mgrid[0:size, 0:size]
    img = np.stack([x * 255 // (size - 1), y * 255 // (size - 1),
                    ((x // 4) % 2) * 200 + 30], -1).astype(np.uint8)
    write_png(path, img)


FEATURE_BSDFS = """
  <bsdf type="roughplastic" id="PlasticFloor">
    <float name="alpha" value="0.2"/><float name="int_ior" value="1.6"/>
    <rgb name="diffuse_reflectance" value="0.6, 0.6, 0.55"/>
    <texture type="checkerboard">
      <rgb name="color0" value="0.2, 0.2, 0.25"/>
      <rgb name="color1" value="0.75, 0.72, 0.7"/>
      <float name="uscale" value="6"/><float name="vscale" value="6"/>
    </texture>
  </bsdf>
  <bsdf type="twosided" id="CheckerWall"><bsdf type="diffuse">
    <texture type="checkerboard">
      <rgb name="color0" value="0.63, 0.065, 0.05"/>
      <rgb name="color1" value="0.3, 0.03, 0.02"/>
      <float name="uscale" value="4"/><float name="vscale" value="4"/>
      <float name="uoffset" value="0.1"/>
    </texture></bsdf></bsdf>
  <bsdf type="twosided" id="Picture"><bsdf type="diffuse">
    <texture type="bitmap"><string name="filename" value="picture.png"/>
    </texture></bsdf></bsdf>
  <bsdf type="dielectric" id="Glass"><float name="int_ior" value="1.5"/></bsdf>
  <bsdf type="roughconductor" id="Gold">
    <float name="alpha" value="0.15"/>
    <rgb name="eta" value="0.14, 0.38, 1.44"/>
    <rgb name="k" value="3.98, 2.38, 1.6"/>
  </bsdf>
  <bsdf type="conductor" id="Mirror"><string name="material" value="none"/></bsdf>
"""

FEATURE_SHAPES = """
  <shape type="sphere"><point name="center" x="-0.45" y="0.3" z="0.35"/>
    <float name="radius" value="0.3"/><ref id="Glass"/></shape>
  <shape type="sphere"><point name="center" x="0.45" y="0.3" z="0.45"/>
    <float name="radius" value="0.3"/><ref id="Gold"/>
    <transform name="toWorld"><matrix value="2 0 0 5 0 2 0 5 0 0 2 5 0 0 0 1"/></transform></shape>
  <shape type="cube"><transform name="toWorld"><matrix value="0.286776 0.098229 -2.29282e-015 -0.335439 -4.36233e-009 1.23382e-008 -0.6 0.6 -0.0997984 0.282266 2.62268e-008 -0.291415 0 0 0 1"/></transform><ref id="Mirror"/></shape>
  <shape type="obj"><string name="filename" value="gem.obj"/>
    <boolean name="faceNormals" value="true"/>
    <transform name="toWorld"><matrix value="0.22 0 0 0.35 0 0.3 0 1.25 0 0 0.22 -0.1 0 0 0 1"/></transform>
    <bsdf type="roughdielectric"><float name="int_ior" value="1.45"/>
      <float name="alpha" value="0.08"/></bsdf></shape>
"""


def feature_emitter(hdr_path: str) -> str:
    return f"""
  <emitter type="envmap"><string name="filename" value="{hdr_path}"/>
    <transform name="toWorld"><matrix value="0 0 1 0 0 1 0 0 -1 0 0 0 0 0 0 1"/></transform>
  </emitter>
"""


def write_feature_scene(dirpath: str) -> str:
    """Write the feature scene, its PNG and its OBJ into ``dirpath``;
    return the XML's path. The envmap names the repository's HDR by a
    path relative to ``dirpath``."""
    os.makedirs(dirpath, exist_ok=True)
    write_picture_png(os.path.join(dirpath, "picture.png"))
    write_octahedron_obj(os.path.join(dirpath, "gem.obj"))
    xml = scene_xml(FEATURE_BSDFS, FEATURE_SHAPES,
                    feature_emitter(os.path.relpath(HDR, dirpath)),
                    floor="PlasticFloor", back="Picture", left="CheckerWall")
    path = os.path.join(dirpath, "feature.xml")
    with open(path, "w") as fh:
        fh.write(xml)
    return path
