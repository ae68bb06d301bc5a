"""Kernels K5 and K6 wrappers: BSDF evaluation and sampling.

``bsdf_eval(mp, it, wo, wi, present)`` keeps the signature and result of
``ops/bsdf.eval_world``, ``bsdf_sample(mp, it, wo, u, present)`` those of
``ops/bsdf.sample_world``: the reference's
``pathtracer_tpu/ops/bsdf.py::eval_f_pdf`` / ``sample_f`` with the frame
changes around their calls in the integrators (world directions into the
hits' shading frame and back, the geometric-normal test, |wi . ns|). CUDA
tensors go to the hand-written kernels of ``csrc/bsdf.cu`` (a thread a
lane, one launch a call, each lane running only its own material's
branch); CPU tensors go to the plain versions. There is no fallback
between the two: a CUDA input that a kernel cannot take raises.

The kernels read the material parameters of ``bsdf.gather_params`` as
they come, by their element strides (column slices of the material rows,
or texture results), and the hits' frame ``it["ss"]``, ``it["ts"]``,
``it["ns"]`` and ``it["ng"]`` (contiguous (N, 3)).

Each launch lies in its ``pt::k:bsdf_eval`` / ``pt::k:bsdf_sample`` span
(``_build.launch``) and, where the scene holds METAL, SUBSTRATE or GLASS,
in one ``pt::bsdf:kernel`` span around it, which the benchmark's
``bsdf_ops_per_ksample`` reads (by the ``pt::bsdf:`` prefix) in the
scenes that hold those types.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ...scene.scene import MAT_GLASS, MAT_METAL, MAT_SUBSTRATE
from ...utils.spans import span
from .. import bsdf
from . import _build

SOURCE = "bsdf.cu"
# the launchers' signatures (ops/cuda/_build.bind): the material (type, s;
# kd, r, c; ks, r, c; eta, s; eta3, r, c; k, r, c; ax, s; ay, s; metallic,
# s) and the frame (ss, ts, ns, ng), then K5 wo, wi; present, n; f, pdf,
# cosine, stream, and K6 wo, u; present, n; wi, f, pdf, specular,
# transmission, cosine, stream
_IN = "pi" + "pii" * 2 + "pi" + "pii" * 2 + "pi" * 3 + "pppp"
SIGNATURES = {"bsdf_eval": _IN + "pp" + "ii" + "pppp",
              "bsdf_sample": _IN + "pp" + "ii" + "ppppppp"}

# kernel launches made by ``bsdf_eval`` and ``bsdf_sample``
# (``_build.launch`` counts them; CPU calls never launch)
LAUNCHES = {"bsdf_eval": 0, "bsdf_sample": 0}
_build.counted(__name__, SIGNATURES)

# the types of a scene whose launches open ``pt::bsdf:kernel``
SPANNED = (MAT_METAL, MAT_SUBSTRATE, MAT_GLASS)
FRAME = ("ss", "ts", "ns", "ng")

_fns = None
_OFF = contextlib.nullcontext()


def build(verbose: bool = False) -> str:
    """Compile csrc/bsdf.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
    return _fns


F32 = torch.float32
I32 = torch.int32
BOOL = torch.bool


@functools.lru_cache(maxsize=None)
def _scene_flags(present: tuple) -> tuple:
    """(the bit mask of ``present``, whether a launch opens
    ``pt::bsdf:kernel``)."""
    mask = 0
    for t in present:
        mask |= 1 << int(t)
    return mask, any(t in present for t in SPANNED)


def _mat_args(mp, dev: int, n: int) -> list:
    """The launchers' material arguments: each of gather_params' tensors
    by pointer and element strides, checked for its dtype, device and
    shape. Raises for a tensor a kernel cannot take."""
    out = []
    for key, dtype, width in (("mtype", I32, 0), ("kd", F32, 3),
                              ("ks", F32, 3), ("eta", F32, 0),
                              ("eta3", F32, 3), ("k", F32, 3),
                              ("ax", F32, 0), ("ay", F32, 0),
                              ("metallic", F32, 0)):
        x = mp[key]
        if not isinstance(x, torch.Tensor) or x.dtype is not dtype:
            raise TypeError(f"mp[{key!r}] must be a {dtype} tensor")
        if not x.is_cuda or x.get_device() != dev:
            raise ValueError(f"mp[{key!r}] is on {x.device}, expected "
                             f"cuda:{dev}")
        if x.shape != ((n, width) if width else (n,)):
            raise ValueError(f"mp[{key!r}] must be "
                             f"{(n, width) if width else (n,)}, got "
                             f"{tuple(x.shape)}")
        out.append(x.data_ptr())
        out.extend(x.stride())
    return out


def _lanes_check(what, lanes: dict, mtype):
    """Check the per-lane inputs ``lanes`` ({name: (tensor, width)}: a
    contiguous (N, width) f32) against ``mtype`` (N,). Returns (the CUDA
    device's index, or -1 for CPU tensors; N)."""
    try:  # the case a launch takes, in the fewest attribute reads
        dev, n = mtype.get_device(), mtype.shape[0]
        if mtype.is_cuda and all(
                x.dtype is F32 and x.get_device() == dev
                and x.is_contiguous() and x.shape == (n, w)
                for x, w in lanes.values()):
            return dev, n
    except (AttributeError, IndexError):  # not a tensor or not 1-D
        pass
    tensors = {k: x for k, (x, _) in lanes.items()}
    if all(isinstance(x, torch.Tensor) and x.is_cpu
           for x in (mtype, *tensors.values())):
        return -1, None
    dev = _build.check(what, dict(mtype=mtype, **tensors),
                       dict(mtype=I32, **{k: F32 for k in tensors}))
    n = mtype.shape[0] if mtype.dim() == 1 else -1
    for k, (x, w) in lanes.items():
        if tuple(x.shape) != (n, w):
            raise ValueError(f"{k} must be {(n, w)}, got {tuple(x.shape)}")
    raise ValueError(f"{what}: inputs the kernel cannot take")


def _frame(it) -> dict:
    return {k: (it[k], 3) for k in FRAME}


def bsdf_eval(mp, it, wo, wi, present=bsdf.ALL_MATERIALS):
    """BSDF f (N, 3), pdf (N,) and |wi . ns| (N,) of the world directions
    wo, wi (N, 3) at the hits ``it``, as ``ops/bsdf.eval_world`` (its
    docstring has the semantics): kernel K5 on the card, the plain version
    on the CPU."""
    dev, n = _lanes_check("bsdf_eval", dict(_frame(it), wo=(wo, 3),
                                            wi=(wi, 3)), mp["mtype"])
    if dev < 0:
        return bsdf.eval_world(mp, it, wo, wi, present=present)
    mask, spanned = _scene_flags(tuple(present))
    f = torch.empty((n, 3), dtype=F32, device=wo.device)
    pdf = torch.empty((n,), dtype=F32, device=wo.device)
    cos = torch.empty((n,), dtype=F32, device=wo.device)
    if n > 0:
        args = _mat_args(mp, dev, n)
        with span("pt::bsdf:kernel") if spanned else _OFF:
            _build.launch(
                (_fns or _load())["bsdf_eval"], "bsdf_eval", dev, *args,
                *(it[k].data_ptr() for k in FRAME), wo.data_ptr(),
                wi.data_ptr(), mask, n, f.data_ptr(), pdf.data_ptr(),
                cos.data_ptr())
    return f, pdf, cos


def bsdf_sample(mp, it, wo, u, present=bsdf.ALL_MATERIALS):
    """Sample the BSDF at the hits ``it`` for the world direction wo (N,
    3) with u (N, 2), as ``ops/bsdf.sample_world`` (its docstring has the
    semantics): kernel K6 on the card, the plain version on the CPU.
    Returns dict(wi, f, pdf, specular, transmission, cos), wi in world
    space."""
    dev, n = _lanes_check("bsdf_sample", dict(_frame(it), wo=(wo, 3),
                                              u=(u, 2)), mp["mtype"])
    if dev < 0:
        return bsdf.sample_world(mp, it, wo, u, present=present)
    mask, spanned = _scene_flags(tuple(present))
    out = dict(wi=torch.empty((n, 3), dtype=F32, device=wo.device),
               f=torch.empty((n, 3), dtype=F32, device=wo.device),
               pdf=torch.empty((n,), dtype=F32, device=wo.device),
               specular=torch.empty((n,), dtype=BOOL, device=wo.device),
               transmission=torch.empty((n,), dtype=BOOL, device=wo.device),
               cos=torch.empty((n,), dtype=F32, device=wo.device))
    if n > 0:
        args = _mat_args(mp, dev, n)
        with span("pt::bsdf:kernel") if spanned else _OFF:
            _build.launch(
                (_fns or _load())["bsdf_sample"], "bsdf_sample", dev, *args,
                *(it[k].data_ptr() for k in FRAME), wo.data_ptr(),
                u.data_ptr(), mask, n, *(x.data_ptr() for x in out.values()))
    return out
