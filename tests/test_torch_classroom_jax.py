"""Classroom end to end: the port's film against the JAX package's.

``data/classroom_proc.glb`` (22,696 triangles, four base-colour PNG
textures, an emissive panel, a directional and a point light) renders at
32x18, 1 spp, depth 2 in both MIS modes: the JAX package's scene through
``interop`` (its own BVH32 table) and the port's own ``load_gltf`` and
``TracedScene.create``. The camera rays carry differentials, so the first
hit's texture lookups take the trilinear path. Films are held to the
cornell golden's bar (RGB RMSE < 1e-3, alpha rtol 1e-5); depth 2 stays
below Russian roulette, as ``tests/test_torch_configs_jax.py`` does.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.integrator import TracedScene as JTracedScene
from pathtracer_tpu.scene.gltf import load_gltf as jload_gltf
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.interop import (camera_from_reference,
                                          traced_scene_from_reference)
from pathtracer_tpu_torch.scene.gltf import load_gltf

torch.set_num_threads(1)

CLASSROOM = "data/classroom_proc.glb"
RES = (32, 18)


@pytest.fixture(scope="module")
def scenes():
    jcam, jsd, _ = jload_gltf(CLASSROOM, resolution=RES)
    cam, sd, _ = load_gltf(CLASSROOM, resolution=RES, device="cpu")
    return jcam, JTracedScene.create(jsd), cam, TracedScene.create(sd)


@pytest.mark.parametrize("mis_mode", ["ref", "onesample"])
def test_classroom_film_matches_jax(scenes, mis_mode):
    jcam, jts, cam, ts = scenes
    cfg = dict(max_depth=2, mis_mode=mis_mode)
    jinteg = JPathIntegrator(JPathConfig(**cfg), spp=1)
    jfilm = np.asarray(jinteg.render(jcam, jts))
    integ = PathIntegrator(PathConfig(**cfg), spp=1)
    film = integ.render(camera_from_reference(jcam),
                        traced_scene_from_reference(jts, device="cpu"))
    film = film.numpy()
    assert film.shape == (RES[1], RES[0], 4)
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()
    assert film[..., :3].mean() > 0.5  # lit
    np.testing.assert_allclose(film[..., 3], jfilm[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((film[..., :3] - jfilm[..., :3]) ** 2))
    assert rmse < 1e-3, rmse
    assert abs(integ.last_ray_count - jinteg.last_ray_count) \
        <= 1e-3 * jinteg.last_ray_count
    # the port's own load and create trace the same table: the same film
    own = PathIntegrator(PathConfig(**cfg), spp=1).render(cam, ts).numpy()
    np.testing.assert_array_equal(own, film)
