"""Data-parallel rendering on torch.distributed, on the CPU: ``gloo``
ranks spawned by ``parallel.mesh.launch`` render cornell 16x16 at depth 2
(as tests/test_render.py's sharded tests do) and config B through the
plain BVH32 traversal.

Every rank draws the single-process render's samples (Sobol seeding is by
pixel position); only the order of the film's sums differs, so the films
are held to the JAX package's bars for its sharded render: atol 2e-5 on a
band mesh, 5e-5 on a bands x samples mesh. Against the JAX package's
``render_sharded`` the bar is the cornell golden's (RMSE < 1e-3 on RGB,
alpha to rtol 1e-5).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.parallel.mesh import (Mesh, launch, make_mesh,
                                                make_mesh_2d, render_sharded)
from torch_mesh_ranks import load, sharded_errors, sharded_film

torch.set_num_threads(1)

CFG = PathConfig(max_depth=2)


def _single(name, resolution, spp):
    cam, sd = load(name, resolution, "cpu")
    return PathIntegrator(CFG, spp=spp).render(cam, sd)


def _assert_films(films, want, atol):
    for film in films:
        assert film.shape == want.shape
        np.testing.assert_allclose(film.numpy(), want.numpy(), rtol=0,
                                   atol=atol)
    # every rank returns the summed film
    for film in films[1:]:
        assert torch.equal(film, films[0])


def test_meshes():
    assert make_mesh(4) == Mesh(("tiles",), {"tiles": 4})
    assert make_mesh(4).size == 4
    m = make_mesh_2d(2, 3)
    assert m.axis_names == ("tiles", "samples")
    assert m.shape == {"tiles": 2, "samples": 3} and m.size == 6


def test_band_mesh_matches_single_process():
    films = launch(4, sharded_film, "cornell", (16, 16), make_mesh(4), CFG,
                   1, device="cpu")
    _assert_films(films, _single("cornell", (16, 16), 1), atol=2e-5)


def test_2d_mesh_matches_single_process():
    films = launch(4, sharded_film, "cornell", (16, 16), make_mesh_2d(2, 2),
                   CFG, 2, device="cpu")
    _assert_films(films, _single("cornell", (16, 16), 2), atol=5e-5)


def test_config_b_on_two_ranks_through_the_bvh():
    films = launch(2, sharded_film, "config_b", (20, 14), make_mesh(2), CFG,
                   2, device="cpu")
    _assert_films(films, _single("config_b", (20, 14), 2), atol=2e-5)


def test_one_rank_is_the_single_process_render():
    """A mesh of one renders the single process's bands in its order:
    the same film, bit for bit."""
    films = launch(1, sharded_film, "cornell", (16, 12), make_mesh(1), CFG,
                   2, device="cpu")
    assert torch.equal(films[0], _single("cornell", (16, 12), 2))


def test_value_errors():
    # a group of 2 for a mesh of 4; spp 1 over 2 sample groups
    assert launch(2, sharded_errors, device="cpu") == [
        ["process group of 2 ranks for a mesh of 4",
         "spp 1 does not divide over 2 sample groups"]] * 2


def test_no_process_group_raises():
    cam, sd = load("cornell", (8, 8), "cpu")
    with pytest.raises(ValueError, match="process group"):
        render_sharded(cam, sd, make_mesh(1), CFG, spp=1)


def test_launch_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(1, sharded_film, "cornell", (8, 8), make_mesh(1), CFG, 1)


@pytest.mark.slow
def test_matches_jax_render_sharded():
    """The JAX package's render_sharded on the conftest's virtual CPU
    devices against the port's gloo ranks, both on a 2 x 2 mesh."""
    import jax
    from pathtracer_tpu.integrator import PathConfig as JPathConfig
    from pathtracer_tpu.parallel.mesh import make_mesh_2d as jmake_mesh_2d
    from pathtracer_tpu.parallel.mesh import \
        render_sharded as jrender_sharded
    from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
    from torch_mesh_ranks import CORNELL
    assert len(jax.devices()) >= 4
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(16, 16))
    want = np.asarray(jrender_sharded(jcam, jsd, jmake_mesh_2d(2, 2),
                                      JPathConfig(max_depth=2), spp=2))
    got = launch(4, sharded_film, "cornell", (16, 16), make_mesh_2d(2, 2),
                 CFG, 2, device="cpu")[0].numpy()
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2))
    assert rmse < 1e-3, rmse
