"""``bench_torch.py`` on the CPU: its twin of ``__graft_entry__.entry()``
renders the band the integrator renders, and the script refuses to run
without a CUDA card (it has no CPU fallback)."""

import pytest
import torch

import bench_torch
from pathtracer_tpu_torch.core.film import film_crop
from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

torch.set_num_threads(1)


def test_graft_entry_twin_renders_the_integrators_band():
    fn, args = bench_torch.graft_entry("cpu")
    film_pad, rays, n_bad = fn(*args)
    film = film_crop(film_pad, 64, 64)
    cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=(64, 64),
                              device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=3), spp=1, band_rows=1000)
    assert integ.band_layout(cam)[1] == 1
    assert torch.equal(film, integ.render(cam, sd))
    assert float(rays) == integ.last_ray_count and float(n_bad) == 0


def test_bench_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        bench_torch.main()
