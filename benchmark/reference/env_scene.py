"""A Mitsuba 0.5 scene of rectangles, cubes and spheres lit by an
environment map alone, as triangles with a material row each, and the
map itself, read from its Radiance file.

The shapes and the BSDFs of ``sphere_scene`` are read as it reads them
(its ``material`` and its meshing), with two BSDFs more:

- ``conductor`` with ``material`` "none" -> MIRROR: specular
  reflection with a Fresnel term of 1 (upstream's importer maps it so);
- ``roughdielectric``: ``alpha``, ``int_ior`` -> ROUGHGLASS: pbrt-v3's
  rough glass, Trowbridge-Reitz reflection (kd = 1) and transmission
  (ks = 1) into the interior ``eta``.

The scene's one emitter is an ``envmap``: its ``filename`` (relative to
the scene's folder), an optional ``toWorld`` matrix, and the importer's
fix of Mitsuba's axes, the Euler rotation (-pi/2, -pi/2, 0) (a rotation
by -pi/2 about x, then by -pi/2 about y) followed by a flip of z. A
shape's emitter and any other scene emitter are refused.

``read_rgbe`` decodes the map: the header up to its first blank line,
the resolution line ``-Y <h> +X <w>``, then ``h`` scanlines top to
bottom, each either run-length encoded channel by channel (the marker
2, 2 and the width in two bytes, then for each of r, g, b, e runs: a
count above 128 repeats the next byte count - 128 times, else that many
literal bytes follow) or ``w`` flat RGBE quadruples. A texel is
``mantissa * 2^(e - 136)``, and 0 where ``e`` is 0, without Radiance's
half-step offset (stb_image and the ``image`` crate decode so).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from . import sphere_scene
from .sphere_scene import MIN_ALPHA

MIRROR, ROUGHGLASS = 4, 5


# ----------------------------------------------------------- the HDR file
def _scanline_rle(data: bytes, pos: int, w: int, out: np.ndarray) -> int:
    """Decode one run-length encoded scanline into ``out`` (w, 4) uint8;
    returns the position after it."""
    for ch in range(4):
        x = 0
        while x < w:
            count = data[pos]
            pos += 1
            if count > 128:
                out[x:x + count - 128, ch] = data[pos]
                x += count - 128
                pos += 1
            else:
                if count == 0:
                    raise ValueError("a zero-length run in an RGBE scanline")
                out[x:x + count, ch] = np.frombuffer(data, np.uint8, count,
                                                     pos)
                x += count
                pos += count
    return pos


def read_rgbe(path: str) -> np.ndarray:
    """The (H, W, 3) float32 radiance of a Radiance RGBE file (module
    text)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise ValueError(f"{path} is not a Radiance file")
    head_end = data.index(b"\n\n") + 2
    line_end = data.index(b"\n", head_end)
    words = data[head_end:line_end].split()
    if len(words) != 4 or words[0] != b"-Y" or words[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {words!r}")
    h, w = int(words[1]), int(words[3])
    rgbe = np.empty((h, w, 4), np.uint8)
    pos = line_end + 1
    for y in range(h):
        if data[pos] == 2 and data[pos + 1] == 2 and \
                (data[pos + 2] << 8 | data[pos + 3]) == w:
            pos = _scanline_rle(data, pos + 4, w, rgbe[y])
        else:
            rgbe[y] = np.frombuffer(data, np.uint8, 4 * w, pos).reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3].astype(np.int64)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136),
                     0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


# -------------------------------------------------------------- the scene
def material(el) -> dict:
    """The material row of a <bsdf> element (``sphere_scene.material``'s,
    with MIRROR and ROUGHGLASS)."""
    kind = el.get("type")
    if kind == "twosided":
        return material(el.find("bsdf"))
    floats = {c.get("name"): float(c.get("value"))
              for c in el.findall("float")}
    strings = {c.get("name"): c.get("value") for c in el.findall("string")}
    one, zero = np.ones(3, np.float32), np.zeros(3, np.float32)
    if kind == "conductor" and strings.get("material") == "none":
        return dict(mtype=MIRROR, kd=one, ks=one, eta=one, k=zero,
                    alpha=np.float32(MIN_ALPHA))
    if kind == "roughdielectric":
        for name in ("alpha", "int_ior"):
            if name not in floats:
                raise ValueError(f"<bsdf type='roughdielectric'> lacks "
                                 f"{name!r}")
        return dict(mtype=ROUGHGLASS, kd=one, ks=one,
                    eta=np.full(3, floats["int_ior"], np.float32), k=zero,
                    alpha=np.float32(max(np.float32(floats["alpha"]),
                                         np.float32(MIN_ALPHA))))
    return sphere_scene.material(el)


def env_light_to_world(to_world) -> np.ndarray:
    """The map's (3, 3) rotation into the world: ``to_world`` (4, 4) after
    the axis fix (module text), in double precision."""
    a = b = -np.pi / 2
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    fix = np.eye(4)
    fix[:3, :3] = (ry @ rx) @ np.diag([1.0, 1.0, -1.0])
    return (np.asarray(to_world, np.float64) @ fix)[:3, :3]


def _matrix(el) -> np.ndarray:
    return np.asarray([float(x) for x in el.find("matrix").get("value")
                       .split()], np.float64).reshape(4, 4)


def load(path: str) -> dict:
    """The scene's triangles as ``sphere_scene.load`` gives them (no area
    light: ``light_tri`` is empty and every ``light`` is -1), and ``env``:
    dict(path of the map, image (H, W, 3) float32, l2w (3, 3) float64)."""
    root = ET.parse(path).getroot()
    folder = os.path.dirname(os.path.abspath(path))
    by_id = {b.get("id"): material(b) for b in root.findall("bsdf")}
    out = {k: [] for k in ("p", "n", "mtype", "kd", "ks", "eta", "k",
                           "alpha")}
    for shape in root.findall("shape"):
        if shape.find("emitter") is not None:
            raise ValueError("the reference renders an environment light "
                             "alone: no emitting shape")
        pos, nrm, tri = sphere_scene._placed(shape)
        ref = shape.find("ref")
        row = by_id[ref.get("id")] if ref is not None \
            else material(shape.find("bsdf"))
        f = len(tri)
        out["p"].append(pos[tri])
        out["n"].append(nrm[tri])
        out["mtype"].append(np.full(f, row["mtype"], np.int64))
        out["alpha"].append(np.full(f, row["alpha"], np.float32))
        for key in ("kd", "ks", "eta", "k"):
            out[key].append(np.broadcast_to(row[key], (f, 3)))
    emitters = root.findall("emitter")
    if len(emitters) != 1 or emitters[0].get("type") != "envmap":
        raise ValueError("the reference renders scenes lit by one envmap")
    em = emitters[0]
    name = {c.get("name"): c.get("value")
            for c in em.findall("string")}["filename"]
    tr = em.find("transform")
    to_world = _matrix(tr) if tr is not None else np.eye(4)
    tris = {k: np.concatenate(v).astype(np.float32) for k, v in out.items()
            if k != "mtype"}
    f = len(tris["p"])
    tris.update(mtype=np.concatenate(out["mtype"]),
                emit=np.zeros((f, 3), np.float32),
                light=np.full(f, -1, np.int64),
                light_tri=np.zeros(0, np.int64),
                env=dict(path=os.path.join(folder, name),
                         image=read_rgbe(os.path.join(folder, name)),
                         l2w=env_light_to_world(to_world)))
    return tris
