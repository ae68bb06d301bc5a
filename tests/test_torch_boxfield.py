"""The port's BVH path as a whole: the box field (the Config E stand-in)
against the JAX package.

The scene must be equal field for field. Films are held to the cornell
golden's bar (RMSE < 1e-3 on RGB, alpha to rtol 1e-5) against the jitted
JAX PathIntegrator at depth 3, where XLA's fusion flips no paths on the
cornell golden either (ROADMAP Queue 3, "The JAX package under jit"). The
single-leaf table (40 boxes) and a two-level one (200 boxes) both run,
each in both MIS modes; each JAX render compiles once, in a module-scoped
fixture.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.integrator import TracedScene as JTracedScene
from pathtracer_tpu.scene.procedural import box_field_scene as jbox_field
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.interop import (camera_from_reference,
                                          traced_scene_from_reference)
from pathtracer_tpu_torch.ops.cuda import bvhw_cu
from pathtracer_tpu_torch.ops.cuda import intersect_cu
from pathtracer_tpu_torch.scene import procedural
from torch_leaves import assert_scene_equal

torch.set_num_threads(1)

RES = (32, 18)
SPP = 2
DEPTH = 3


@pytest.fixture(scope="module")
def jax_films():
    """{(n_boxes, mis_mode): (camera, JAX TracedScene, jitted JAX film)}."""
    out = {}
    for n_boxes in (40, 200):
        jcam, jsd = jbox_field(RES, n_boxes=n_boxes)
        jts = JTracedScene.create(jsd)
        for mis in ("ref", "onesample"):
            integ = JPathIntegrator(JPathConfig(max_depth=DEPTH,
                                                mis_mode=mis), spp=SPP)
            out[n_boxes, mis] = (jcam, jts,
                                 np.asarray(integ.render(jcam, jts)))
    return out


def _assert_film_close(got, want):
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2))
    assert rmse < 1e-3, rmse


def test_box_field_scene_matches_jax():
    cam, sd = procedural.box_field_scene(RES, n_boxes=40,
                                       device="cpu")
    jcam, jsd = jbox_field(RES, n_boxes=40)
    assert sd.p0.shape[0] == 40 * 12 + 12
    assert_scene_equal(sd, jsd)
    for f in dataclasses.fields(cam):
        np.testing.assert_array_equal(np.asarray(getattr(cam, f.name)),
                                      np.asarray(getattr(jcam, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("mis_mode", ["ref", "onesample"])
@pytest.mark.parametrize("n_boxes", [40, 200])
def test_box_field_film_matches_jitted_jax(jax_films, n_boxes, mis_mode):
    """The port's own scene and build, rendered through the BVH route on
    the CPU (the plain K2: no kernel launch, no K1)."""
    jcam, jts, jfilm = jax_films[n_boxes, mis_mode]
    cam, sd = procedural.box_field_scene(RES, n_boxes=n_boxes,
                                       device="cpu")
    ts = TracedScene.create(sd)
    assert ts.bw_rows is not None
    assert ts.bw_depth == jts.bw_depth == (1 if n_boxes == 40 else 2)
    k1, k2 = intersect_cu.LAUNCHES, bvhw_cu.LAUNCHES
    integ = PathIntegrator(PathConfig(max_depth=DEPTH, mis_mode=mis_mode),
                           spp=SPP)
    film = integ.render(cam, ts).numpy()
    assert (intersect_cu.LAUNCHES, bvhw_cu.LAUNCHES) == (k1, k2)
    assert film.shape == (RES[1], RES[0], 4)
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()
    _assert_film_close(film, jfilm)
    # the reference's own table through interop gives the same film
    film2 = PathIntegrator(PathConfig(max_depth=DEPTH, mis_mode=mis_mode),
                           spp=SPP).render(camera_from_reference(jcam),
                                           traced_scene_from_reference(
                                               jts, device="cpu"))
    np.testing.assert_array_equal(film2.numpy(), film)


@pytest.mark.parametrize("name", ["small_scene", "microfacet_scene",
                                  "envmap_disney_scene"])
def test_other_configs_raise(name):
    """Configs B, C and D build on the card by default: without one, a
    call that does not ask for the CPU raises rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default call succeeds")
    with pytest.raises((AssertionError, RuntimeError)):
        getattr(procedural, name)((16, 16))
    cam, sd = getattr(procedural, name)((16, 16), device="cpu")
    assert sd.device.type == "cpu" and sd.p0.shape[0] > 128
