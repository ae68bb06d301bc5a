"""Kernel K9 wrapper: the light sample and the light density of area,
point and distant lights.

``light_sample`` gives each lane's light sample (``ops/lights.py``
``sample_li``: wi, pdf, radiance, the target point, its error and normal,
and the flags of the row's light type) and ``light_pdf`` the area light's
density along wi (``pdf_li``), for lanes of light rows (N, LA_WIDTH) and
the light set's types. CUDA tensors go to the hand-written kernels of
``csrc/light.cu`` (a thread a lane, everything in registers, one launch a
call); CPU tensors go to the plain twins ``ops/lights.sample_li_plain`` /
``pdf_li_plain``, which the kernels equal bit for bit. There is no
fallback between the two: a CUDA input that a kernel cannot take raises.
Where the set holds the environment beside other types, its lanes take
kernel K8's sample or density (``ops/cuda/env_cu.py``, in its ``pt::env``
span), which K9 reads.

``ops/lights.py``'s ``sample_li`` and ``pdf_li`` call these inside their
``pt::light`` span, for a light set with an area, point or distant light
(``pdf_li``: with an area light); each launch lies in its
``pt::k:light_sample`` / ``pt::k:light_pdf`` span (``_build.launch``)
within it.
"""

from __future__ import annotations

import torch

from ...scene.scene import (LA_WIDTH, LIGHT_AREA, LIGHT_DISTANT,
                            LIGHT_INFINITE, LIGHT_POINT)
from .. import lights as lt
from ..intersect import GAMMA2, GAMMA3, GAMMA5
from . import _build

SOURCE = "light.cu"
# the launchers' signatures (ops/cuda/_build.bind): light_sample (rows,
# ref_p, ref_err, ref_n, u, world_radius, env_wi, env_pdf, env_li; n;
# gamma 2, 3, 5, 6; out, flags, stream) and light_pdf (rows, ref_p,
# ref_err, ref_n, wi, env_pdf; n, every; gamma 2, 3, 5; out, stream)
SIGNATURES = {"light_sample": "ppppppppp" + "i" + "ffff" + "ppp",
              "light_pdf": "pppppp" + "ii" + "fff" + "pp"}

# kernel launches made by ``light_sample`` and ``light_pdf``
# (``_build.launch`` counts them; CPU calls never launch)
LAUNCHES = {"light_sample": 0, "light_pdf": 0}
_build.counted(__name__, SIGNATURES)

F32 = torch.float32
# the light types the kernels evaluate themselves
OWN_TYPES = (LIGHT_AREA, LIGHT_POINT, LIGHT_DISTANT)
ALL_LIGHTS = OWN_TYPES + (LIGHT_INFINITE,)

_fns = None


def build(verbose: bool = False) -> str:
    """Compile csrc/light.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
    return _fns


def light_sample(scene, light_rows, ref_p, ref_err, ref_n, u,
                 light_set=ALL_LIGHTS):
    """``sample_li`` for each lane's light row: dict(wi, pdf, li,
    target_p, target_err, target_n, is_delta, is_env, is_area), K9's
    ``light_sample`` on the card (with K8's sample for the environment's
    lanes), ``lights.sample_li_plain`` on the CPU. ``light_set`` must hold
    an area, point or distant light, and the type of every row: the
    kernel evaluates each lane's own row type, which is what the plain
    chain selects for it there (the scene's ``light_attr`` rows and its
    ``light_set`` are such)."""
    tensors = dict(light_rows=light_rows, ref_p=ref_p, ref_err=ref_err,
                   ref_n=ref_n, u=u, world_radius=scene.world_radius)
    dev = _build.device("light_sample", tensors, dict(
        light_rows=LA_WIDTH, ref_p=3, ref_err=3, ref_n=3, u=2,
        world_radius=()))
    if dev < 0:
        return lt.sample_li_plain(scene, light_rows, ref_p, ref_err, ref_n,
                                  u, light_set=light_set)
    if not any(t in light_set for t in OWN_TYPES):
        raise ValueError(f"light_sample: no area, point or distant light in "
                         f"the light set {light_set}")
    # K8's sample, held here until K9 has read it
    env = lt._env_sample_li(scene, u) \
        if LIGHT_INFINITE in light_set else None
    n = light_rows.shape[0]
    out = torch.empty((16 * n,), dtype=F32, device=light_rows.device)
    flags = torch.empty((3, n), dtype=torch.bool, device=light_rows.device)
    if n > 0:
        _build.launch(
            (_fns or _load())["light_sample"], "light_sample", dev,
            light_rows.data_ptr(), ref_p.data_ptr(), ref_err.data_ptr(),
            ref_n.data_ptr(), u.data_ptr(), scene.world_radius.data_ptr(),
            *(0, 0, 0) if env is None else (t.data_ptr() for t in env),
            n, GAMMA2, GAMMA3, GAMMA5, lt.GAMMA6,
            out.data_ptr(), flags.data_ptr())
    wi, li, target_p, target_err, target_n = out[:15 * n].view(
        5, n, 3).unbind(0)
    is_delta, is_env, is_area = flags.unbind(0)
    return dict(wi=wi, pdf=out[15 * n:], li=li, target_p=target_p,
                target_err=target_err, target_n=target_n, is_delta=is_delta,
                is_env=is_env, is_area=is_area)


def light_pdf(scene, light_rows, ref_p, ref_err, ref_n, wi,
              light_set=ALL_LIGHTS):
    """``pdf_li`` for each lane's light row along wi (N,): K9's
    ``light_pdf`` on the card (with K8's density for the environment's
    lanes), ``lights.pdf_li_plain`` on the CPU. ``light_set`` must hold an
    area light."""
    tensors = dict(light_rows=light_rows, ref_p=ref_p, ref_err=ref_err,
                   ref_n=ref_n, wi=wi)
    dev = _build.device("light_pdf", tensors, dict(
        light_rows=LA_WIDTH, ref_p=3, ref_err=3, ref_n=3, wi=3))
    if dev < 0:
        return lt.pdf_li_plain(scene, light_rows, ref_p, ref_err, ref_n, wi,
                               light_set=light_set)
    if LIGHT_AREA not in light_set:
        raise ValueError(f"light_pdf: no area light in the light set "
                         f"{light_set}")
    every = int(len(light_set) == 1)
    # K8's density, held here until K9 has read it
    env_pdf = lt.env_pdf_li(scene, wi) \
        if not every and LIGHT_INFINITE in light_set else None
    n = light_rows.shape[0]
    out = torch.empty((n,), dtype=F32, device=light_rows.device)
    if n > 0:
        _build.launch(
            (_fns or _load())["light_pdf"], "light_pdf", dev,
            light_rows.data_ptr(), ref_p.data_ptr(), ref_err.data_ptr(),
            ref_n.data_ptr(), wi.data_ptr(),
            0 if env_pdf is None else env_pdf.data_ptr(), n, every, GAMMA2,
            GAMMA3, GAMMA5, out.data_ptr())
    return out
