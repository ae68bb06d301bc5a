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
    its (reordered) SceneData and its tables, so both packages trace
    identical trees: the BVH32 table ``bw_rows`` and depth ``bw_depth``;
    for a split alpha subset the flag, ``n_opaque`` and the subset's table
    ``bwa_rows``, map ``bwa_map`` and depth ``bwa_depth``; where every
    triangle is masked, the binary tree's node rows and leaf size."""
    def host(name):
        a = getattr(ts, name)
        return None if a is None else np.asarray(a)
    # the binary tree's rows: only where no BVH32 table replaced it
    nodes = None if ts.bvh is None or ts.bw_rows is not None \
        else np.asarray(ts.bvh.nodes)
    return TracedScene.from_tables(
        scene_from_reference(ts.data, device), host("bw_rows"),
        int(ts.bw_depth), split_alpha=bool(ts.split_alpha),
        n_opaque=int(ts.n_opaque), bwa_rows=host("bwa_rows"),
        bwa_map=host("bwa_map"), bwa_depth=int(ts.bwa_depth),
        bvh_nodes=nodes,
        max_leaf=4 if ts.bvh is None else int(ts.bvh.max_leaf))


def camera_from_reference(cam) -> Camera:
    """The reference's host ``Camera`` -> this package's ``Camera``."""
    return Camera(**{f.name: getattr(cam, f.name)
                     for f in dataclasses.fields(Camera)})
