"""Classroom without ray differentials: the port's ``no_diff=True``
against the JAX package under its environment switch ``PTPU_NO_DIFF=1``.

Every texture lookup then reads level 0, as every bounce past the first
does anyway. 32x18, 1 spp, depth 2, "onesample", at the cornell golden's
bar (RGB RMSE < 1e-3, alpha rtol 1e-5). The switch is read when the JAX
render is traced, so the test clears JAX's compiled programs first.
"""

import jax
import numpy as np
import torch

from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.scene.gltf import load_gltf as jload_gltf
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.scene.gltf import load_gltf

torch.set_num_threads(1)

CLASSROOM = "data/classroom_proc.glb"
RES = (32, 18)


def test_no_diff_matches_jax_without_differentials(monkeypatch):
    cfg = dict(max_depth=2, mis_mode="onesample")
    jcam, jsd, _ = jload_gltf(CLASSROOM, resolution=RES)
    monkeypatch.setenv("PTPU_NO_DIFF", "1")
    jax.clear_caches()
    jfilm = np.asarray(JPathIntegrator(JPathConfig(**cfg), spp=1).render(
        jcam, jsd))
    jax.clear_caches()
    cam, sd, _ = load_gltf(CLASSROOM, resolution=RES, device="cpu")
    ts = TracedScene.create(sd)
    film = PathIntegrator(PathConfig(**cfg), spp=1, no_diff=True).render(
        cam, ts).numpy()
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()
    np.testing.assert_allclose(film[..., 3], jfilm[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((film[..., :3] - jfilm[..., :3]) ** 2))
    assert rmse < 1e-3, rmse
    # the differentials matter on this scene: with them the film differs
    with_diff = PathIntegrator(PathConfig(**cfg), spp=1).render(
        cam, ts).numpy()
    assert np.sqrt(np.mean((with_diff[..., :3] - film[..., :3]) ** 2)) \
        > 1e-3
