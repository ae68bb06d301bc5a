"""Kernel K1 wrapper: brute-force watertight intersection on Hopper.

``intersect(o, d, t_max, tri_pack, any_hit=False)`` keeps the signature
and return dict of the TPU kernel ``pathtracer_tpu/ops/pallas/
intersect_pl.py::intersect_pallas``. CUDA tensors go to the hand-written
kernel in ``csrc/intersect.cu``; CPU tensors go to ``intersect_plain``,
the plain PyTorch version built on ``ops/intersect.py``. There is no
fallback between the two: a CUDA input that the kernel cannot take raises.

The kernel is compiled with nvcc at first use (``ops/cuda/_build.py``:
``build/``, keyed by a hash of the source and flags) and launched through
``_build.launch``.
"""

from __future__ import annotations

import torch

from ..intersect import (GAMMA2, GAMMA3, GAMMA5, intersect_brute,
                         intersect_p_brute)
from . import _build

SOURCE = "intersect.cu"

# the launcher's signature (ops/cuda/_build.bind): o, d, t_max, tri_pack;
# n, f, any_hit; g2, g3, g5; valid, t, tri, b, stream
SIGNATURES = {"intersect": "ppppiiifffppppp"}

# kernel launches made by ``intersect`` (CPU calls never count)
LAUNCHES = 0

_fns = None


def build(verbose: bool = False) -> str:
    """Compile csrc/intersect.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
    return _fns


def intersect_plain(o, d, t_max, tri_pack, any_hit: bool = False):
    """The plain PyTorch version of K1, with the kernel's output contract:
    closest hit -> dict(valid, t (0 on a miss), tri (0 on a miss), b
    (0 on a miss)); any-hit -> (N,) bool."""
    p0, p1, p2 = tri_pack[:, 0:3], tri_pack[:, 3:6], tri_pack[:, 6:9]
    if any_hit:
        return intersect_p_brute(o, d, t_max, p0, p1, p2)
    hit = intersect_brute(o, d, t_max, p0, p1, p2)
    hit["b"] = torch.where(hit["valid"][:, None], hit["b"], 0.0)
    return hit


F32 = torch.float32


def _check(o, d, t_max, tri_pack):
    """Check (N, 3) o and d, (N,) t_max and an (F, 12) tri_pack, all f32.
    Returns (the CUDA device's index, or -1 for CPU tensors; N)."""
    try:  # the case a launch takes, in the fewest attribute reads
        dev, shape, fshape = o.get_device(), o.shape, tri_pack.shape
        if o.dtype is F32 and d.dtype is F32 and t_max.dtype is F32 \
                and tri_pack.dtype is F32 and o.is_cuda \
                and d.get_device() == dev and t_max.get_device() == dev \
                and tri_pack.get_device() == dev and o.is_contiguous() \
                and d.is_contiguous() and t_max.is_contiguous() \
                and tri_pack.is_contiguous() and len(shape) == 2 \
                and shape[1] == 3 and d.shape == shape \
                and t_max.shape == shape[:1] and len(fshape) == 2 \
                and fshape[1] == 12:
            return dev, shape[0]
    except AttributeError:  # not a tensor: check raises for it
        pass
    dev = _build.check("intersect", dict(o=o, d=d, t_max=t_max,
                                         tri_pack=tri_pack), F32)
    n = o.shape[0] if o.dim() == 2 else -1
    if o.dim() != 2 or o.shape[1] != 3 or tuple(d.shape) != (n, 3):
        raise ValueError(f"o, d must be (N, 3), got {tuple(o.shape)}, "
                         f"{tuple(d.shape)}")
    if tuple(t_max.shape) != (n,):
        raise ValueError(f"t_max must be ({n},), got {tuple(t_max.shape)}")
    if tri_pack.dim() != 2 or tri_pack.shape[1] != 12:
        raise ValueError(f"tri_pack must be (F, 12), got "
                         f"{tuple(tri_pack.shape)}")
    return dev, n


def intersect(o, d, t_max, tri_pack, any_hit: bool = False):
    """Closest hit (or any-hit) of every ray against every triangle.

    o, d: (N, 3) f32; t_max: (N,) f32; tri_pack: (F, 12) f32 rows
    [p0 p1 p2 pad]. Returns dict(valid (N,) bool, t (N,), tri (N,) i32,
    b (N, 3)) or, with any_hit, an (N,) bool tensor.
    """
    global LAUNCHES
    dev, n = _check(o, d, t_max, tri_pack)
    if dev < 0:
        return intersect_plain(o, d, t_max, tri_pack, any_hit)
    valid = torch.empty_like(t_max, dtype=torch.bool)
    if any_hit:
        outs = (valid.data_ptr(), 0, 0, 0)
    else:
        t = torch.empty_like(t_max)
        tri = torch.empty_like(t_max, dtype=torch.int32)
        b = torch.empty_like(o)
        outs = (valid.data_ptr(), t.data_ptr(), tri.data_ptr(), b.data_ptr())
    if n > 0:
        _build.launch(
            (_fns or _load())["intersect"], "intersect", dev, o.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), tri_pack.data_ptr(), n,
            tri_pack.shape[0], int(bool(any_hit)), GAMMA2, GAMMA3, GAMMA5,
            *outs)
        LAUNCHES += 1
    if any_hit:
        return valid
    return dict(valid=valid, t=t, tri=tri, b=b)
