"""light_strategy="all": one NEE sample per light on the light's own
sampler slots, summed. The port's films against the JAX package's.

Cornell (two area lights, K1's route), config B (a point and a distant
light, the BVH route) and a small scene with an area, a point and a
distant light, at 32x32, 1 spp, depth 2, in both MIS modes, under the
Sobol sampler and the stratified one (whose latin-hypercube arrays feed
the per-light draws): RGB RMSE < 1e-3, alpha rtol 1e-5 and the ray count
within 1e-3, the bar of ``tests/test_torch_configs_jax.py``. Depth 2
stays below Russian roulette, where the jitted JAX render and its
op-by-op bounce differ (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.core.camera import Camera as JCamera
from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.scene import meshgen as jmeshgen
from pathtracer_tpu.scene import procedural as jprocedural
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu.scene.scene import SceneBuilder as JSceneBuilder
from pathtracer_tpu_torch.core.camera import Camera
from pathtracer_tpu_torch.integrator import (MAX_ALL_LIGHTS, PathConfig,
                                             PathIntegrator)
from pathtracer_tpu_torch.scene import meshgen, procedural
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.scene import MAT_MATTE, SceneBuilder

torch.set_num_threads(1)

CORNELL = "data/cornell-box.xml"
RES = (32, 32)


def _plane(x_axis, y_axis, origin):
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 3] = x_axis, y_axis, origin
    m[:3, 2] = np.cross(x_axis, y_axis) / np.linalg.norm(x_axis) \
        / np.linalg.norm(y_axis)
    return m


def mixed_scene(builder_cls, mg, camera_cls, resolution, n_quads=1,
                **build_kw):
    """A floor and a cube under ``n_quads`` emissive quads (two area
    lights each), a point light and a distant light; either package's
    SceneBuilder, meshgen and Camera."""
    b = builder_cls()
    white = b.add_material(mtype=MAT_MATTE, kd=(0.7, 0.68, 0.65))
    red = b.add_material(mtype=MAT_MATTE, kd=(0.6, 0.1, 0.08))
    black = b.add_material(mtype=MAT_MATTE, kd=(0, 0, 0))
    pos, idx, nrm, _ = mg.gen_rectangle()
    p, n = mg.transform_mesh(pos, nrm, _plane([4, 0, 0], [0, 0, -4],
                                              [0, 0, 0]))
    b.add_mesh(p, idx, n, None, white)
    cp, ci, cn, _ = mg.gen_cube()
    m = np.diag([0.6, 0.6, 0.6, 1.0])
    m[:3, 3] = [0.5, 0.6, 0.0]
    p, n = mg.transform_mesh(cp, cn, m)
    b.add_mesh(p, ci, n, None, red)
    for q in range(n_quads):
        p, n = mg.transform_mesh(pos, nrm, _plane(
            [0.4, 0, 0], [0, 0, 0.4], [-1.5 + 0.3 * q, 2.5, -0.5]))
        b.add_mesh(p, idx, n, None, black,
                   emission=np.asarray([6.0, 5.0, 4.0], np.float32))
    b.add_point_light([1.5, 2.0, 1.0], (5.0, 5.0, 5.0))
    b.add_distant_light((-0.3, 1.0, 0.4), (0.8, 0.8, 0.75))
    cam = camera_cls.look_at([0.0, 2.0, 5.0], [0.0, 0.5, 0.0], [0, 1, 0],
                             np.pi / 4, resolution)
    return cam, b.build(**build_kw)


def _scenes(name):
    """(JAX camera and scene, port camera and scene) of one case."""
    if name == "cornell":
        jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=RES)
        cam, sd, _ = load_mitsuba(CORNELL, resolution=RES, device="cpu")
    elif name == "B":
        jcam, jsd = jprocedural.small_scene(RES)
        cam, sd = procedural.small_scene(RES, device="cpu")
    else:
        jcam, jsd = mixed_scene(JSceneBuilder, jmeshgen, JCamera, RES)
        cam, sd = mixed_scene(SceneBuilder, meshgen, Camera, RES,
                              device="cpu")
    return (jcam, jsd), (cam, sd)


CASES = [(scene, mis, sampler) for scene in ("cornell", "B")
         for mis in ("ref", "onesample") for sampler in ("sobol",
                                                          "stratified")] + \
    [("mixed", "ref", "sobol"), ("mixed", "onesample", "stratified"),
     ("cornell", "onesample", "random")]


@pytest.mark.parametrize("scene,mis_mode,sampler", CASES)
def test_all_lights_film_matches_jax(scene, mis_mode, sampler):
    cfg = dict(max_depth=2, mis_mode=mis_mode, sampler=sampler,
               light_strategy="all")
    (jcam, jsd), (cam, sd) = _scenes(scene)
    assert int(sd.n_lights) >= 2
    jinteg = JPathIntegrator(JPathConfig(**cfg), spp=1)
    jfilm = np.asarray(jinteg.render(jcam, jsd))
    integ = PathIntegrator(PathConfig(**cfg), spp=1)
    film = integ.render(cam, sd).numpy()
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()
    np.testing.assert_allclose(film[..., 3], jfilm[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((film[..., :3] - jfilm[..., :3]) ** 2))
    assert rmse < 1e-3, rmse
    assert abs(integ.last_ray_count - jinteg.last_ray_count) \
        <= 1e-3 * jinteg.last_ray_count


def test_all_lights_cap():
    """24 lights render (their slots pass the Sobol table's last
    dimension from depth 10 on, which clamps); more raise, as the
    reference's assert does."""
    cam, sd = mixed_scene(SceneBuilder, meshgen, Camera, (4, 4),
                          n_quads=11, device="cpu")
    assert int(sd.n_lights) == MAX_ALL_LIGHTS == 24
    film = PathIntegrator(PathConfig(max_depth=10, light_strategy="all"),
                          spp=1).render(cam, sd)
    assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
    cam, sd = mixed_scene(SceneBuilder, meshgen, Camera, (4, 4),
                          n_quads=12, device="cpu")
    assert int(sd.n_lights) == 26
    with pytest.raises(ValueError, match="capped at 24"):
        PathIntegrator(PathConfig(max_depth=1, light_strategy="all"),
                       spp=1).render(cam, sd)
    jcam, jsd = mixed_scene(JSceneBuilder, jmeshgen, JCamera, (4, 4),
                            n_quads=12)
    with pytest.raises(AssertionError, match="capped at 24"):
        JPathIntegrator(JPathConfig(max_depth=1, light_strategy="all"),
                        spp=1).render(jcam, jsd)
