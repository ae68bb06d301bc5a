"""``TracedScene.create``'s ``use_bvh``: one scene through either route.

The reference's ``TracedScene.create(sd, use_bvh=None, max_leaf=4)``
picks the BVH route above 128 triangles and lets a caller force either.
The port takes the same argument (not ``use_pallas``: a TPU switch), so a
render crosses kernel K1 (brute force) against kernel K2 (the BVH32
table) on one scene. Films are held to the cornell golden's bar (RMSE <
1e-3 on RGB, alpha to rtol 1e-5).
"""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.integrator import TracedScene as JTracedScene
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.scene import procedural
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")


def _assert_film_close(got, want):
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2))
    assert rmse < 1e-3, rmse


def _render(cam, scene, depth=3, spp=2):
    return PathIntegrator(PathConfig(max_depth=depth), spp=spp).render(
        cam, scene).numpy()


@pytest.fixture(scope="module")
def cornell():
    """The cornell golden's configuration (32x32) on the CPU, and both of
    the port's routes for it."""
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(32, 32), device="cpu")
    return cam, sd, {use: TracedScene.create(sd, use_bvh=use)
                     for use in (None, False, True)}


def test_use_bvh_picks_the_route(cornell):
    _, sd, scenes = cornell
    assert int(sd.p0.shape[0]) == 36
    assert scenes[None].bw_rows is None and scenes[False].bw_rows is None
    table = scenes[True].bw_rows
    assert table is not None and table.shape[1] == 256
    assert torch.equal(scenes[None].tri_pack, scenes[False].tri_pack)
    # the BVH route reorders the triangles into its leaf order
    assert sorted(map(tuple, scenes[True].tri_pack.tolist())) == \
        sorted(map(tuple, scenes[False].tri_pack.tolist()))


def test_cornell_k1_and_k2_routes_agree(cornell):
    """The golden configuration through K1's and K2's plain versions."""
    cam, _, scenes = cornell
    _assert_film_close(_render(cam, scenes[True]), _render(cam, scenes[False]))


@pytest.mark.slow
def test_cornell_bvh_route_matches_jax_bvh_film(cornell):
    """The port's BVH route against the reference's, both forced with
    ``use_bvh=True`` (the JAX render compiles its traversal: slow)."""
    cam, _, scenes = cornell
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(32, 32))
    jscene = JTracedScene.create(jsd, use_bvh=True)
    assert jscene.bw_rows is not None
    jfilm = np.asarray(JPathIntegrator(JPathConfig(max_depth=3), spp=2)
                       .render(jcam, jscene))
    _assert_film_close(_render(cam, scenes[True]), jfilm)


def test_brute_force_route_above_128_triangles():
    """``use_bvh=False`` on config B (2,210 triangles): K1's route takes
    any triangle count and renders what the BVH route renders."""
    cam, sd = procedural.small_scene((16, 12), device="cpu")
    assert int(sd.p0.shape[0]) > 128
    brute = TracedScene.create(sd, use_bvh=False)
    assert brute.bw_rows is None
    bvh = TracedScene.create(sd)
    assert bvh.bw_rows is not None
    _assert_film_close(_render(cam, brute, depth=2, spp=1),
                       _render(cam, bvh, depth=2, spp=1))


def test_unknown_mitsuba_shape_names_item_9b(tmp_path):
    """A shape the importer lacks points at the item that adds it."""
    with open(CORNELL) as fh:
        text = fh.read()
    xml = tmp_path / "sphere.xml"
    xml.write_text(text.replace("</scene>",
                                '<shape type="sphere"/></scene>'))
    with pytest.raises(NotImplementedError, match="shape type 'sphere'.*"
                       "item 9b"):
        load_mitsuba(str(xml), device="cpu")


def test_checkpoint_names_item_3(cornell):
    """``render_progressive`` takes the reference's ``checkpoint``
    argument; saving and resuming are ROADMAP Queue 1 item 3's."""
    cam, _, scenes = cornell
    integ = PathIntegrator(PathConfig(max_depth=1), spp=1)
    with pytest.raises(NotImplementedError, match="checkpoint.*item 3"):
        integ.render_progressive(cam, scenes[None], chunk_spp=None,
                                 callback=None, checkpoint="x")
    film = integ.render_progressive(cam, scenes[None], None, None, None)
    assert film.shape == (32, 32, 4)
