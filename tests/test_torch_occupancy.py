"""The occupancy counters, always on in the port (the JAX package's
``PathConfig.count_occupancy``): the live lanes a bounce, summed over a
render's bands and frames into ``PathIntegrator.bounce_occupancy``,
against the JAX package's; and the lane-bounces live and run over the
integrator's renders, ``PathIntegrator.lane_bounces``.

Bounce 0 counts the camera lanes and must match exactly; later bounces
within 0.1 %, as XLA's jit flips a few grazing lanes' outcomes (ROADMAP
Queue 3, "The JAX package under jit"). Counting changes no film bit.
"""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.scene import procedural
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")
COUNT = PathConfig(max_depth=3)


@pytest.fixture(scope="module")
def cornell32():
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(32, 32), device="cpu")
    return cam, TracedScene.create(sd)


def test_matches_jax_bounce_occupancy(cornell32):
    from pathtracer_tpu.integrator import PathConfig as JPathConfig
    from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
    from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
    cam, scene = cornell32
    integ = PathIntegrator(COUNT, spp=2)
    integ.render(cam, scene)
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(32, 32))
    jinteg = JPathIntegrator(JPathConfig(max_depth=3, count_occupancy=True),
                             spp=2)
    jinteg.render(jcam, jsd)
    got, want = integ.bounce_occupancy, jinteg.bounce_occupancy
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == (4,)
    # every camera lane of the 36 x 36 sample rectangle, twice
    assert got[0] == want[0] == 36 * 36 * 2
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
    assert (np.diff(got) <= 0).all()


def test_chunked_render_counts_what_a_whole_one_does(cornell32):
    cam, scene = cornell32
    whole = PathIntegrator(COUNT, spp=4, band_rows=12)
    f_whole = whole.render(cam, scene)
    chunked = PathIntegrator(COUNT, spp=4, band_rows=12)
    seen = []
    f_chunked = chunked.render_progressive(
        cam, scene, chunk_spp=1,
        callback=lambda film, done: seen.append(
            chunked.bounce_occupancy.copy()))
    np.testing.assert_array_equal(chunked.bounce_occupancy,
                                  whole.bounce_occupancy)
    # read once a chunk, summed so far
    assert [s[0] for s in seen] == [36 * 36 * k for k in (1, 2, 3, 4)]
    np.testing.assert_allclose(f_chunked.numpy(), f_whole.numpy(), atol=2e-5)
    # a second render starts from zero
    whole.render(cam, scene)
    np.testing.assert_array_equal(whole.bounce_occupancy,
                                  chunked.bounce_occupancy)


@pytest.mark.parametrize("scene_name", ["cornell", "config_b"])
def test_counting_changes_no_film_bit(scene_name):
    if scene_name == "cornell":
        cam, sd, _ = load_mitsuba(CORNELL, resolution=(20, 16),
                                  device="cpu")
    else:
        cam, sd = procedural.small_scene((20, 16), device="cpu")
    scene = TracedScene.create(sd)
    cfg = PathConfig(max_depth=3, mis_mode="onesample")
    plain = PathIntegrator(cfg, spp=2)
    counted = PathIntegrator(cfg, spp=2)
    inner = plain.render_frames
    # the plain render's band-frames are handed no count to add into
    plain.render_frames = lambda su, film_pad, band, s0, n_frames, occ: \
        inner(su, film_pad, band, s0, n_frames, None)
    assert torch.equal(plain.render(cam, scene), counted.render(cam, scene))
    assert plain.bounce_occupancy.tolist() == [0.0] * 4
    assert counted.bounce_occupancy[0] == 24 * 20 * 2
    assert plain.last_ray_count == counted.last_ray_count
