"""``render_progressive(checkpoint=...)``: save, resume, and the file of
either package resumed by the other.

The file holds the padded film, the next sample frame and the spp, as the
reference writes it. The port writes it before it calls the progress
callback (the reference calls the callback first, so a stop inside the
callback loses the chunk; ROADMAP Queue 3). Films are held to the cornell
golden's bar (RMSE < 1e-3 on RGB, alpha to rtol 1e-5).
"""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu_torch.core.film import film_crop
from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")
# both packages' film_pad holds band extra rows: one band height for both
BAND = 16


class _Stop(Exception):
    pass


def _assert_film_close(got, want):
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2))
    assert rmse < 1e-3, rmse


@pytest.fixture(scope="module")
def cornell():
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(32, 32), device="cpu")
    return cam, sd


def _integ(spp=2):
    return PathIntegrator(PathConfig(max_depth=1), spp=spp, band_rows=BAND)


def test_checkpoint_path_without_extension(tmp_path, cornell):
    """``checkpoint=foo`` saves AND resumes from foo.npz (np.savez appends
    the extension; the resume check must agree)."""
    cam, sd = cornell
    ck = str(tmp_path / "ck_no_ext")
    integ = PathIntegrator(PathConfig(max_depth=1), spp=2)
    f1 = integ.render_progressive(cam, sd, chunk_spp=1, checkpoint=ck)
    assert (tmp_path / "ck_no_ext.npz").exists()
    assert not (tmp_path / "ck_no_ext").exists()
    integ2 = PathIntegrator(PathConfig(max_depth=1), spp=2)
    f2 = integ2.render_progressive(cam, sd, chunk_spp=1, checkpoint=ck)
    assert torch.equal(f1, f2)
    assert integ2.last_ray_count == 0.0  # resumed at next_frame == spp


def test_checkpoint_is_written_before_the_callback(tmp_path, cornell):
    """When the callback runs, the file already holds the chunk it is
    called for; a stop inside the callback loses nothing."""
    cam, sd = cornell
    ck = str(tmp_path / "ck.npz")
    seen = []

    def callback(film, done):
        with np.load(ck) as z:
            seen.append((done, int(z["next_frame"]), int(z["spp"])))
            saved = film_crop(torch.as_tensor(z["film_pad"]), 32, 32)
        assert torch.equal(saved, film)
        if done == 1:
            raise _Stop

    with pytest.raises(_Stop):
        _integ().render_progressive(cam, sd, chunk_spp=1, callback=callback,
                                    checkpoint=ck)
    assert seen == [(1, 1, 2)]
    # resumed: only the second chunk runs, and the film is the whole one's
    integ = _integ()
    film = integ.render_progressive(cam, sd, chunk_spp=1, checkpoint=ck)
    whole = _integ()
    assert torch.equal(film, whole.render_progressive(cam, sd, chunk_spp=1))
    assert 0 < integ.last_ray_count < whole.last_ray_count


def test_checkpoint_of_another_spp_is_not_resumed(tmp_path, cornell):
    cam, sd = cornell
    ck = str(tmp_path / "ck.npz")
    _integ(spp=1).render_progressive(cam, sd, checkpoint=ck)
    integ = _integ(spp=2)
    film = integ.render_progressive(cam, sd, chunk_spp=1, checkpoint=ck)
    assert torch.equal(film, _integ(spp=2).render_progressive(cam, sd,
                                                              chunk_spp=1))
    with np.load(ck) as z:
        assert (int(z["next_frame"]), int(z["spp"])) == (2, 2)


def _jax_film_and_checkpoint(ck, stop_at):
    """The JAX package's cornell film of 2 spp in chunks of 1, with its
    checkpoint at ``ck``; its callback (called before its save) stops the
    render at chunk ``stop_at``, after capturing the film."""
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(32, 32))
    films = {}

    def callback(film, done):
        films[done] = np.asarray(film)
        if done == stop_at:
            raise _Stop

    with pytest.raises(_Stop):
        JPathIntegrator(JPathConfig(max_depth=1), spp=2,
                        band_rows=BAND).render_progressive(
            jcam, jsd, chunk_spp=1, callback=callback, checkpoint=ck)
    return films


def test_port_resumes_a_jax_checkpoint(tmp_path, cornell):
    """JAX stops after chunk 1 of 2 (its callback stops chunk 2 before
    the save); the port resumes the file and finishes with the JAX
    film."""
    cam, sd = cornell
    ck = str(tmp_path / "jax_ck")
    films = _jax_film_and_checkpoint(ck, stop_at=2)
    with np.load(ck + ".npz") as z:
        assert int(z["next_frame"]) == 1
    integ = _integ()
    film = integ.render_progressive(cam, sd, chunk_spp=1, checkpoint=ck)
    _assert_film_close(film.numpy(), films[2])
    assert integ.last_ray_count > 0


def test_jax_resumes_a_port_checkpoint(tmp_path, cornell):
    """The port stops inside its callback after chunk 1, its file already
    written; the JAX package resumes it and finishes with the port's
    film."""
    cam, sd = cornell
    ck = str(tmp_path / "port_ck.npz")

    def stop(film, done):
        raise _Stop

    with pytest.raises(_Stop):
        _integ().render_progressive(cam, sd, chunk_spp=1, callback=stop,
                                    checkpoint=ck)
    whole = _integ().render_progressive(cam, sd, chunk_spp=1).numpy()
    jcam, jsd, _ = jload_mitsuba(CORNELL, resolution=(32, 32))
    jfilm = JPathIntegrator(JPathConfig(max_depth=1), spp=2,
                            band_rows=BAND).render_progressive(
        jcam, jsd, chunk_spp=1, checkpoint=ck)
    _assert_film_close(np.asarray(jfilm), whole)
