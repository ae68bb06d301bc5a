"""The integrator's t_max rule: lanes whose result is discarded test nothing.

The bounce's closest-hit query gives t_max 0 to the lanes that are not
active, on both routes; the shadow query to the lanes whose light term is
zero (``branch1`` false) or that the caller drops (not ``nonspec``); the
"ref" BSDF branch's query to the lanes outside ``branch2`` or ``nonspec``.
Both kernels skip such a lane and report a miss, so only lanes that are
masked out change: the films must be bit-identical to renders in which
every query tests every lane with its full t_max. Here that is done by
wrapping ``_scene_intersect`` / ``_scene_intersect_p`` so they drop their
``live`` mask (the rule before it: t_max inf on every lane of a closest-hit
query, the shadow ray's own bound on every lane of an any-hit one).
"""

import os

import pytest
import torch

from pathtracer_tpu_torch import integrator as integ_mod
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.scene import procedural
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")


def _scene(name):
    if name == "cornell":
        cam, sd, _ = load_mitsuba(CORNELL, resolution=(32, 32), device="cpu")
    else:  # config B: above 128 triangles, the BVH route (K2)
        cam, sd = procedural.small_scene((32, 24), device="cpu")
    return cam, TracedScene.create(sd)


def _every_lane(fn, calls):
    """``fn`` with its ``live`` mask dropped, counting the masks it got."""
    def wrapped(scene, o, d, t_max, live=None):
        calls.append(live is not None)
        return fn(scene, o, d, t_max)
    return wrapped


@pytest.mark.parametrize("name,mis_mode", [("cornell", "ref"),
                                           ("cornell", "onesample"),
                                           ("small_scene", "ref"),
                                           ("small_scene", "onesample")])
def test_dead_lanes_leave_the_film_bit_identical(monkeypatch, name,
                                                 mis_mode):
    cam, scene = _scene(name)
    assert (scene.bw_rows is None) == (name == "cornell")
    integ = PathIntegrator(PathConfig(max_depth=5, mis_mode=mis_mode), spp=2)
    film = integ.render(cam, scene)
    rays = integ.last_ray_count

    calls = []
    monkeypatch.setattr(integ_mod, "_scene_intersect",
                        _every_lane(integ_mod._scene_intersect, calls))
    monkeypatch.setattr(integ_mod, "_scene_intersect_p",
                        _every_lane(integ_mod._scene_intersect_p, calls))
    old = integ.render(cam, scene)
    # every query of the render came with a mask, and each was dropped
    assert calls and all(calls)
    assert torch.equal(film, old)
    assert integ.last_ray_count == rays
    assert bool((film[..., 3] > 0).all())


def test_lane_bounds():
    o = torch.zeros(4, 3)
    live = torch.tensor([True, False, True, False])
    t = torch.tensor([1.0, 2.0, float("nan"), -1.0])
    got = integ_mod._lane_bounds(o, t, live)
    assert got[0] == 1.0 and got[1] == 0.0 and got[3] == 0.0
    assert torch.isnan(got[2])
    assert torch.equal(integ_mod._lane_bounds(o, torch.inf, live),
                       torch.tensor([torch.inf, 0.0, torch.inf, 0.0]))
    assert torch.equal(integ_mod._lane_bounds(o, torch.inf, None),
                       torch.full((4,), torch.inf))
    assert integ_mod._lane_bounds(o, t, None) is t  # already contiguous
