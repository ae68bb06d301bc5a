"""The check that decides ``correct``, driven through the harness on the
CPU at small sizes (the harness's look for a card skipped): a sound run
passes; the control and each fault a one-card cell can have fail it,
under the cells' own limits. The exchange between cards is a fault no
one-card cell can have.

- ``unchanged``: a step (one band's chunk of frames) that returns the
  film as it was given;
- ``half``: half of every wave's lanes left out (their radiance dropped);
- ``altered``: every sample's radiance altered by 0.5 % where it is made;
- the control: the reference, rounded to bfloat16 at each stage, in the
  program's place.
"""

import numpy as np
import pytest
import torch

from harness import check, manifest, runner

MAN = manifest.load_manifest()
SMALL = {
    "cornell-640-preview": dict(resolution=[64, 48], job_spp=4, pass_spp=1,
                                check=dict(tiles=4, tile_px=8),
                                seconds=1.0),
}
SEED = 2**31 + 11


def small(cell_name):
    entry = manifest.cell(MAN, cell_name)
    size = dict(SMALL[cell_name])
    seconds = size.pop("seconds")
    traffic = dict(manifest.traffic(entry["traffic"]), **size)
    return (manifest.config(MAN, entry["config"]), traffic,
            manifest.limits(cell_name), seconds)


def run_small(cell_name, trace_on=False):
    cfg, traffic, limits, seconds = small(cell_name)
    return runner.run_cell(cfg, traffic, limits,
                           manifest.metrics_for(MAN, cell_name, trace_on),
                           SEED, seconds, trace_on, "cpu")


def _unchanged(monkeypatch):
    """Every second band chunk returns the film as it was given."""
    from pathtracer_tpu_torch.integrator import PathIntegrator

    inner = PathIntegrator.render_frames
    calls = [0]

    def render_frames(self, su, film_pad, band, s0, n_frames, occ=None):
        calls[0] += 1
        if calls[0] % 2 == 0:
            zero = torch.zeros((), device=film_pad.device)
            return film_pad, zero, zero
        return inner(self, su, film_pad, band, s0, n_frames, occ)

    monkeypatch.setattr(PathIntegrator, "render_frames", render_frames)


def _wave(monkeypatch, alter):
    import pathtracer_tpu_torch.integrator as integ

    inner = integ.trace_wave

    def trace_wave(*args, **kw):
        out, rays, bad = inner(*args, **kw)
        return alter(out), rays, bad

    monkeypatch.setattr(integ, "trace_wave", trace_wave)


def _half(monkeypatch):
    def drop(out):
        keep = (torch.arange(out.shape[0], device=out.device) % 2 == 0)
        return torch.where(keep[:, None], out, 0.0)
    _wave(monkeypatch, drop)


def _altered(monkeypatch):
    _wave(monkeypatch, lambda out: out * 1.005)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    result = run_small(cell)
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    assert "msamples_per_s" in result["metrics"]


class _TwoPasses:
    """Holds the window open until its second pass has ended."""

    done = False

    def on_pass(self, index):
        self.done = index >= 2


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", list(SMALL))
def test_fault_fails_the_check(cell, fault, monkeypatch):
    from harness.program import Program

    window = Program.window
    monkeypatch.setattr(Program, "window",
                        lambda self, seconds, views, tracer=None:
                        window(self, seconds, views, tracer or _TwoPasses()))
    FAULTS[fault](monkeypatch)
    result = run_small(cell)
    assert result["attempted"] >= 2
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_the_check(cell):
    """The bfloat16 control in the program's place, at two frames."""
    cfg, traffic, limits, _ = small(cell)
    from harness import workload

    view = workload.moved_camera(cfg, traffic, SEED)
    tiles = workload.check_tiles(SEED, traffic)
    ref = runner.reference_film(cfg, traffic, view, tiles, 2, "cpu")
    ctl = runner.reference_film(cfg, traffic, view, tiles, 2, "cpu",
                                control=torch.bfloat16)
    numbers = check.compare(ctl, ref)
    correct, _ = check.judge(numbers, limits)
    assert not correct, numbers
    assert np.isfinite(ref).all()


def test_trace_records_on_the_cpu():
    """A traced run reads its span and counters (no device ops here)."""
    result = run_small("cornell-640-preview", trace_on=True)
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result


@pytest.mark.cuda
def test_cornell_on_the_card(card):
    cfg, traffic, limits, _ = small("cornell-640-preview")
    result = runner.run_cell(
        cfg, traffic, limits,
        manifest.metrics_for(MAN, "cornell-640-preview", True), SEED, 2.0,
        True, "cuda")
    assert result["correct"], result["check"]
    assert result["device"]["busy_s"] > 0
    assert result["metrics"]["device_ops_per_ksample"]["value"] > 0
