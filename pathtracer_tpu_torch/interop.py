"""Bridges from the JAX package's host objects to this package's.

The JAX package is not imported: its objects are read by attribute name
and their leaves converted with ``np.asarray``, so this module works on any
object carrying the same fields (host numpy or device arrays alike).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.camera import Camera
from .integrator import TracedScene
from .scene.scene import SceneData
from .scene.texture import TexturePool


def scene_from_reference(sd, device="cuda") -> SceneData:
    """The reference's ``SceneData`` -> this package's ``SceneData`` of
    tensors on ``device``, its texture pool leaf for leaf."""
    def leaves(obj, cls):
        return {f.name: torch.as_tensor(np.array(getattr(obj, f.name)),
                                        device=device)
                for f in dataclasses.fields(cls) if f.name != "tex"}
    return SceneData(tex=TexturePool(**leaves(sd.tex, TexturePool)),
                     **leaves(sd, SceneData))


def traced_scene_from_reference(ts, device="cuda"):
    """The reference's ``TracedScene`` -> this package's, on ``device``:
    its (reordered) SceneData and, for BVH scenes, its BVH32 table
    ``bw_rows`` and depth ``bw_depth``, so both packages trace one
    identical table."""
    bw_rows = getattr(ts, "bw_rows", None)
    return TracedScene.from_tables(
        scene_from_reference(ts.data, device),
        None if bw_rows is None else np.asarray(bw_rows),
        int(ts.bw_depth))


def camera_from_reference(cam) -> Camera:
    """The reference's host ``Camera`` -> this package's ``Camera``."""
    return Camera(**{f.name: getattr(cam, f.name)
                     for f in dataclasses.fields(Camera)})
