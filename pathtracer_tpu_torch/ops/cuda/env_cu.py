"""Kernel K8 wrapper: the environment light evaluated and sampled.

``env_eval`` gives the environment's radiance and its solid-angle pdf
along world directions, each where asked, and ``env_sample`` samples it
at u (N, 2) as (wi, pdf, radiance); both read the scene's environment
fields (``SceneData.env_*``, ``world_to_env``, ``env_to_world``,
``has_env``: a scene without an environment holds 1x1 zero tables). CUDA
tensors go to the hand-written kernels of ``csrc/env.cu`` (a thread a
lane, everything in registers, one launch a call); CPU tensors go to the
plain twins ``ops/lights.env_eval_plain`` / ``env_sample_plain``, which
the kernels equal bit for bit. There is no fallback between the two: a
CUDA input that a kernel cannot take raises.

``ops/lights.py``'s ``env_le``, ``env_pdf_li``, ``env_le_pdf`` and
``_env_sample_li`` call these inside their ``pt::env`` span; each launch
lies in its ``pt::k:env_eval`` / ``pt::k:env_sample`` span
(``_build.launch``) within it.
"""

from __future__ import annotations

import torch

from .. import lights as lt
from . import _build

SOURCE = "env.cu"
# the launchers' signatures (ops/cuda/_build.bind): env_eval (d,
# world_to_env, map, cond_func, marg_int, has_env; n, h, w, nv, nu; le,
# pdf, stream) and env_sample (u, env_to_world, map, cond_func, cond_cdf,
# cond_int, marg_func, marg_cdf, marg_int; n, h, w, nv, nu; wi, pdf, le,
# stream)
SIGNATURES = {"env_eval": "pppppp" + "iiiii" + "ppp",
              "env_sample": "ppppppppp" + "iiiii" + "pppp"}

# kernel launches made by ``env_eval`` and ``env_sample``
# (``_build.launch`` counts them; CPU calls never launch)
LAUNCHES = {"env_eval": 0, "env_sample": 0}
_build.counted(__name__, SIGNATURES)

F32 = torch.float32
# the scene fields each kernel reads, in its launcher's order
EVAL_FIELDS = ("world_to_env", "env_map", "env_cond_func", "env_marg_int",
               "has_env")
SAMPLE_FIELDS = ("env_to_world", "env_map", "env_cond_func", "env_cond_cdf",
                 "env_cond_int", "env_marg_func", "env_marg_cdf",
                 "env_marg_int")
# each input's dtype: x (the directions or u) and the scene's fields
DTYPES = {"x": F32, **{f: torch.bool if f == "has_env" else F32
                       for f in EVAL_FIELDS + SAMPLE_FIELDS}}

_fns = None


def build(verbose: bool = False) -> str:
    """Compile csrc/env.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
    return _fns


def _shapes_ok(scene, fields) -> bool:
    """The fields' shapes as the kernels index them: the map (h, w, 3),
    the rotations (3, 3), the 2-D tables of nv rows of nu cells."""
    img, func = scene.env_map, scene.env_cond_func
    if img.dim() != 3 or img.shape[2] != 3 or func.dim() != 2:
        return False
    nv, nu = func.shape
    want = dict(world_to_env=(3, 3), env_to_world=(3, 3),
                env_cond_cdf=(nv, nu + 1), env_cond_int=(nv,),
                env_marg_func=(nv,), env_marg_cdf=(nv + 1,),
                env_marg_int=(), has_env=())
    return min(img.shape[:2] + func.shape) > 0 and all(
        tuple(getattr(scene, f).shape) == want[f] for f in fields
        if f in want)


def _device(what: str, x, width: int, scene, fields) -> int:
    """``_build.device`` of a call on x (N, width) and the scene's
    ``fields``."""
    return _build.device(what, {"x": x, **{f: getattr(scene, f)
                                           for f in fields}},
                         {"x": width}, DTYPES, _shapes_ok(scene, fields))


def env_eval(scene, d, le: bool = True, pdf: bool = False):
    """The environment's radiance (N, 3; zero without one) and solid-angle
    pdf (N,) along world directions d (N, 3), each where asked (else
    None): K8's ``env_eval`` on the card, ``lights.env_eval_plain`` on
    the CPU."""
    dev = _device("env_eval", d, 3, scene, EVAL_FIELDS)
    if dev < 0:
        return lt.env_eval_plain(scene, d, le=le, pdf=pdf)
    n = d.shape[0]
    out_le = torch.empty((n, 3), dtype=F32, device=d.device) if le else None
    out_pdf = torch.empty((n,), dtype=F32, device=d.device) if pdf else None
    if n > 0 and (le or pdf):
        h, w = scene.env_map.shape[:2]
        nv, nu = scene.env_cond_func.shape
        _build.launch(
            (_fns or _load())["env_eval"], "env_eval", dev, d.data_ptr(),
            *(getattr(scene, f).data_ptr() for f in EVAL_FIELDS), n, h, w,
            nv, nu, 0 if out_le is None else out_le.data_ptr(),
            0 if out_pdf is None else out_pdf.data_ptr())
    return out_le, out_pdf


def env_sample(scene, u):
    """The environment sampled at u (N, 2): (wi (N, 3) world directions,
    their solid-angle pdf (N,), radiance (N, 3)), both zero where the
    sample's density is not > 0: K8's ``env_sample`` on the card,
    ``lights.env_sample_plain`` on the CPU."""
    dev = _device("env_sample", u, 2, scene, SAMPLE_FIELDS)
    if dev < 0:
        return lt.env_sample_plain(scene, u)
    n = u.shape[0]
    wi = torch.empty((n, 3), dtype=F32, device=u.device)
    pdf = torch.empty((n,), dtype=F32, device=u.device)
    le = torch.empty((n, 3), dtype=F32, device=u.device)
    if n > 0:
        h, w = scene.env_map.shape[:2]
        nv, nu = scene.env_cond_func.shape
        _build.launch(
            (_fns or _load())["env_sample"], "env_sample", dev, u.data_ptr(),
            *(getattr(scene, f).data_ptr() for f in SAMPLE_FIELDS), n, h, w,
            nv, nu, wi.data_ptr(), pdf.data_ptr(), le.data_ptr())
    return wi, pdf, le
