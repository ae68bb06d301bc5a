"""Configs B, C and D: the port's film against the JAX package's.

Both packages render the same scene (the JAX package's, through
``interop``, and the port's own build) at 16x16, 1 spp, depth 2, in both
MIS modes, and must agree at the cornell golden's bar (RGB RMSE < 1e-3,
alpha rtol 1e-5): the same Sobol samples and the same f32 arithmetic
leave only last-bit divergence. Depth 2 stays below Russian roulette,
where the jitted JAX render and its op-by-op bounce differ (ROADMAP
Queue 3).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.scene import procedural as jprocedural
from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.interop import (camera_from_reference,
                                          scene_from_reference)
from pathtracer_tpu_torch.scene import procedural

torch.set_num_threads(1)

NAMES = {"B": "small_scene", "C": "microfacet_scene",
         "D": "envmap_disney_scene"}


@pytest.mark.parametrize("mis_mode", ["ref", "onesample"])
@pytest.mark.parametrize("config", sorted(NAMES))
def test_config_film_matches_jax(config, mis_mode):
    cfg = dict(max_depth=2, mis_mode=mis_mode)
    jcam, jsd = getattr(jprocedural, NAMES[config])((16, 16))
    jinteg = JPathIntegrator(JPathConfig(**cfg), spp=1)
    jfilm = np.asarray(jinteg.render(jcam, jsd))
    cam, sd = getattr(procedural, NAMES[config])((16, 16), device="cpu")
    integ = PathIntegrator(PathConfig(**cfg), spp=1)
    film = integ.render(cam, sd).numpy()
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()
    np.testing.assert_allclose(film[..., 3], jfilm[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((film[..., :3] - jfilm[..., :3]) ** 2))
    assert rmse < 1e-3, rmse
    assert abs(integ.last_ray_count - jinteg.last_ray_count) \
        <= 1e-3 * jinteg.last_ray_count
    # the JAX scene through interop renders the same film
    film2 = PathIntegrator(PathConfig(**cfg), spp=1).render(
        camera_from_reference(jcam),
        scene_from_reference(jsd, device="cpu")).numpy()
    np.testing.assert_array_equal(film2, film)
