"""Configs B, C and D through the port on the CPU.

Each config's scene equals the JAX package's field for field, and its
64x64 film (band_rows 16, 2 spp, "ref" MIS, depths 4, 6 and 4) meets the
committed golden of ``tests/test_golden.py`` at that file's
``_golden_check`` bar: alpha to rtol 1e-5, RGB RMSE < 2e-3, mean within
2 %. All three scenes exceed 128 triangles, so every query takes the BVH
route; on the CPU that is the plain traversal, with no kernel launch.
The films against the JAX package's own are in
``tests/test_torch_configs_jax.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.scene import procedural as jprocedural
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.ops.cuda import bvhw_cu, intersect_cu
from pathtracer_tpu_torch.scene import procedural
from torch_leaves import assert_scene_equal

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))

# config: (builder, golden, max_depth), as tests/test_golden.py renders
CONFIGS = {
    "B": ("small_scene", "golden_small_64.npz", 4),
    "C": ("microfacet_scene", "golden_microfacet_64.npz", 6),
    "D": ("envmap_disney_scene", "golden_envmap_64.npz", 4),
}


def golden_check(film, ref):
    """tests/test_golden.py's _golden_check bar."""
    np.testing.assert_allclose(film[..., 3], ref[..., 3], rtol=1e-5)
    f, r = film[..., :3], ref[..., :3]
    rmse = np.sqrt(np.mean((f - r) ** 2))
    assert rmse < 2e-3, rmse
    assert abs(f.mean() - r.mean()) < 0.02 * r.mean() + 1e-4
    return rmse


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_config_scene_matches_jax(config):
    name = CONFIGS[config][0]
    cam, sd = getattr(procedural, name)((32, 24), device="cpu")
    jcam, jsd = getattr(jprocedural, name)((32, 24))
    assert_scene_equal(sd, jsd)
    for f in dataclasses.fields(cam):
        np.testing.assert_array_equal(np.asarray(getattr(cam, f.name)),
                                      np.asarray(getattr(jcam, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_config_64_matches_golden(config):
    name, golden, depth = CONFIGS[config]
    cam, sd = getattr(procedural, name)((64, 64), device="cpu")
    ts = TracedScene.create(sd)
    assert ts.bw_rows is not None and sd.p0.shape[0] > 2000
    launches = (intersect_cu.LAUNCHES, bvhw_cu.LAUNCHES)
    integ = PathIntegrator(PathConfig(max_depth=depth), spp=2, band_rows=16)
    film = integ.render(cam, ts).numpy()
    assert (intersect_cu.LAUNCHES, bvhw_cu.LAUNCHES) == launches
    assert film.shape == (64, 64, 4)
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()
    assert integ.bad_sample_count == 0.0
    golden_check(film, np.load(os.path.join(HERE, golden))["film"])


def test_config_flags():
    """The static flags that pick the bounce's branches."""
    flags = {}
    for config, (name, _, _) in CONFIGS.items():
        _, sd = getattr(procedural, name)((16, 16), device="cpu")
        ts = TracedScene.create(sd)
        flags[config] = (ts.mat_set, ts.light_set, ts.tex_channels,
                         ts.has_env, ts.n_lights)
    assert flags == {
        "B": ((0, 1, 2), (1, 2), (True, False, False, False), False, 2),
        "C": ((0, 2, 3, 4), (0,), (False,) * 4, False, 2),
        "D": ((0, 5), (3,), (False,) * 4, True, 1),
    }
