"""The leaves of a SceneData of either package, by the port's field names,
the texture pool's leaves included: what the parity tests compare."""

import dataclasses

import numpy as np
import torch

from pathtracer_tpu_torch.scene.scene import SceneData
from pathtracer_tpu_torch.scene.texture import TexturePool


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scene_leaves(sd) -> list:
    """[(name, host array)] of every leaf of ``sd``; the pool's as
    ``tex.<field>``."""
    out = []
    for f in dataclasses.fields(SceneData):
        if f.name == "tex":
            out += [("tex." + g.name, _host(getattr(sd.tex, g.name)))
                    for g in dataclasses.fields(TexturePool)]
        else:
            out.append((f.name, _host(getattr(sd, f.name))))
    return out


def assert_scene_equal(sd, want):
    """Every leaf of ``sd`` equal to ``want``'s, dtypes included."""
    for (name, a), (_, b) in zip(scene_leaves(sd), scene_leaves(want)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
