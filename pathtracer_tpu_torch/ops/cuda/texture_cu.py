"""Kernels K3 and K4 wrappers: texture evaluation and the alpha cut test.

``texture_eval(scene, txd_id, uv, fallback, duv=None, image=True)`` keeps
the signature and result of ``ops/bsdf.eval_texture`` (the reference's
``pathtracer_tpu/ops/bsdf.py::eval_texture`` with the mip-pool lookup of
``pathtracer_tpu/scene/texture.py``); ``alpha_cut(scene, hit)`` those of
``integrator._alpha_cut`` (the reference's
``pathtracer_tpu/integrator.py::_alpha_cut``). CUDA tensors go to the
hand-written kernels of ``csrc/texture.cu`` (a thread a lane, one launch a
call); CPU tensors go to the plain PyTorch versions
``ops/bsdf.eval_texture_plain`` and ``integrator._alpha_cut_plain``. There
is no fallback between the two: a CUDA input that a kernel cannot take
raises.

The kernels read the scene's packed descriptor tables
(``SceneData.txd_rows``, built once from the txd_* leaves and the pool by
``scene/texture.pack_descriptors``); the plain versions read the leaves.
"""

from __future__ import annotations

import torch

from ...scene.scene import TA_WIDTH
from .. import bsdf
from ..intersect import GAMMA7
from . import _build

SOURCE = "texture.cu"
# the launchers' signatures (ops/cuda/_build.bind): K3 txf, txi, data,
# txd_id, uv, fallback; fb_row, fb_col; dudx, dvdx, dudy, dvdy; n,
# width_mode, image; out, stream. K4 txf, txi, data, tri_attr, tri, b,
# valid; n; gamma7; cut, p_hit, p_err, ng, stream
SIGNATURES = {"texture_eval": "ppppppiippppiiipp",
              "alpha_cut": "pppppppifppppp"}

# kernel launches made by ``texture_eval`` and ``alpha_cut``
# (``_build.launch`` counts them; CPU calls never launch)
LAUNCHES = {"texture_eval": 0, "alpha_cut": 0}
_build.counted(__name__, SIGNATURES)

_fns = None


def build(verbose: bool = False) -> str:
    """Compile csrc/texture.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
    return _fns


F32 = torch.float32
I32 = torch.int32


def _on_cpu(*tensors) -> bool:
    return all(isinstance(x, torch.Tensor) and x.is_cpu for x in tensors)


def _texture_check(scene, txd_id, uv, fallback, duv):
    """Check (N,) i32 txd_id, (N, 2) f32 uv, an (N, 3) f32 fallback of
    any strides and, in width mode, four (N,) f32 derivatives, on the
    pool's device. Returns (the CUDA device's index, or -1 for CPU
    tensors; N)."""
    data = scene.tex.data
    try:  # the case a launch takes, in the fewest attribute reads
        dev, n = txd_id.get_device(), txd_id.shape[0]
        if txd_id.dtype is I32 and uv.dtype is F32 \
                and fallback.dtype is F32 and txd_id.is_cuda \
                and uv.get_device() == dev and fallback.get_device() == dev \
                and data.get_device() == dev and txd_id.is_contiguous() \
                and uv.is_contiguous() and txd_id.dim() == 1 \
                and uv.shape == (n, 2) and fallback.shape == (n, 3) \
                and (duv is None or all(
                    x.dtype is F32 and x.get_device() == dev
                    and x.is_contiguous() and x.shape == (n,)
                    for x in duv)):
            return dev, n
    except (AttributeError, IndexError):  # not a tensor or not 1-D
        pass
    inputs = dict(txd_id=txd_id, uv=uv, pool=data)
    inputs.update(zip(("dudx", "dvdx", "dudy", "dvdy"), duv or ()))
    if _on_cpu(fallback, *inputs.values()):
        return -1, None
    dtypes = {name: F32 for name in inputs}
    dtypes["txd_id"] = I32
    dev = _build.check("texture_eval", inputs, dtypes)
    # the fallback may have any strides (it arrives expanded)
    if not isinstance(fallback, torch.Tensor) or fallback.dtype is not F32:
        raise TypeError("fallback must be a torch.float32 tensor")
    if fallback.device != uv.device:
        raise ValueError(f"fallback is on {fallback.device}, expected "
                         f"{uv.device}")
    n = txd_id.shape[0] if txd_id.dim() == 1 else -1
    if txd_id.dim() != 1 or tuple(uv.shape) != (n, 2):
        raise ValueError(f"txd_id, uv must be (N,), (N, 2), got "
                         f"{tuple(txd_id.shape)}, {tuple(uv.shape)}")
    if tuple(fallback.shape) != (n, 3):
        raise ValueError(f"fallback must be ({n}, 3), got "
                         f"{tuple(fallback.shape)}")
    if duv is not None and any(tuple(x.shape) != (n,) for x in duv):
        raise ValueError(f"duv must be four ({n},) tensors")
    raise ValueError("texture_eval: inputs the kernel cannot take")


def texture_eval(scene, txd_id, uv, fallback, duv=None, image: bool = True):
    """Texture descriptors ``txd_id`` (N,) of ``scene`` (a SceneData)
    evaluated at uv (N, 2), ``fallback`` (N, 3) where txd_id < 0; as
    ``ops/bsdf.eval_texture`` (its docstring has the semantics). With
    ``duv`` (four (N,) UV derivatives) the image lookup is trilinear at
    their filter width, without it bilinear at level 0: the caller picks
    the mode, the kernel never derives it from the data. Returns (N, 3)
    f32.
    """
    dev, n = _texture_check(scene, txd_id, uv, fallback, duv)
    if dev < 0:
        return bsdf.eval_texture_plain(scene, txd_id, uv, fallback, duv=duv,
                                       image=image)
    out = torch.empty((n, 3), dtype=F32, device=uv.device)
    if n > 0:
        txf, txi = scene.txd_rows
        fb_row, fb_col = fallback.stride()
        derivs = (0, 0, 0, 0) if duv is None else \
            tuple(x.data_ptr() for x in duv)
        _build.launch(
            (_fns or _load())["texture_eval"], "texture_eval", dev,
            txf.data_ptr(), txi.data_ptr(), scene.tex.data.data_ptr(),
            txd_id.data_ptr(), uv.data_ptr(), fallback.data_ptr(), fb_row,
            fb_col, *derivs, n, int(duv is not None), int(bool(image)),
            out.data_ptr())
    return out


def _cut_check(scene, hit):
    """Check an (F, TA_WIDTH) f32 tri_attr, (N,) i32 tri, (N, 3) f32 b
    and (N,) bool valid, contiguous, on the pool's device. Returns (the
    CUDA device's index, or -1 for CPU tensors; N)."""
    tri_attr, data = scene.tri_attr, scene.data.tex.data
    tri, b, valid = hit["tri"], hit["b"], hit["valid"]
    try:  # the case a launch takes, in the fewest attribute reads
        dev, n = tri.get_device(), tri.shape[0]
        if tri.dtype is I32 and b.dtype is F32 \
                and valid.dtype is torch.bool and tri_attr.dtype is F32 \
                and tri.is_cuda and b.get_device() == dev \
                and valid.get_device() == dev \
                and tri_attr.get_device() == dev \
                and data.get_device() == dev and tri.is_contiguous() \
                and b.is_contiguous() and valid.is_contiguous() \
                and tri_attr.is_contiguous() and tri.dim() == 1 \
                and b.shape == (n, 3) and valid.shape == (n,) \
                and tri_attr.dim() == 2 and tri_attr.shape[1] == TA_WIDTH:
            return dev, n
    except (AttributeError, IndexError):  # not a tensor or not 1-D
        pass
    inputs = dict(tri=tri, b=b, valid=valid, tri_attr=tri_attr, pool=data)
    if _on_cpu(*inputs.values()):
        return -1, None
    dev = _build.check("alpha_cut", inputs, dict(
        tri=I32, b=F32, valid=torch.bool, tri_attr=F32, pool=F32))
    n = tri.shape[0] if tri.dim() == 1 else -1
    if tri.dim() != 1 or tuple(b.shape) != (n, 3) \
            or tuple(valid.shape) != (n,):
        raise ValueError(f"tri, b, valid must be (N,), (N, 3), (N,), got "
                         f"{tuple(tri.shape)}, {tuple(b.shape)}, "
                         f"{tuple(valid.shape)}")
    raise ValueError(f"tri_attr must be (F, {TA_WIDTH}), got "
                     f"{tuple(tri_attr.shape)}")


def alpha_cut(scene, hit):
    """The alpha cut test of the hit records ``hit`` (valid, tri, b) of a
    TracedScene ``scene``, as ``integrator._alpha_cut``: lanes whose valid
    hit lands on a zero-alpha texel of a masked triangle (the mask at
    width 0, its scale and sRGB included). Returns (cut (N,) bool, p_hit,
    p_err, ng (N, 3) f32) for the re-spawn."""
    dev, n = _cut_check(scene, hit)
    if dev < 0:
        # imported here: the integrator imports this module
        from ...integrator import _alpha_cut_plain
        return _alpha_cut_plain(scene, hit)
    b = hit["b"]
    cut = torch.empty((n,), dtype=torch.bool, device=b.device)
    p_hit = torch.empty_like(b)
    p_err = torch.empty_like(b)
    ng = torch.empty_like(b)
    if n > 0:
        sd = scene.data
        txf, txi = sd.txd_rows
        _build.launch(
            (_fns or _load())["alpha_cut"], "alpha_cut", dev,
            txf.data_ptr(), txi.data_ptr(), sd.tex.data.data_ptr(),
            scene.tri_attr.data_ptr(), hit["tri"].data_ptr(), b.data_ptr(),
            hit["valid"].data_ptr(), n, GAMMA7, cut.data_ptr(),
            p_hit.data_ptr(), p_err.data_ptr(), ng.data_ptr())
    return cut, p_hit, p_err, ng
