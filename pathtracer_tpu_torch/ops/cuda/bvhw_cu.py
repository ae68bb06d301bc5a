"""Kernel K2 wrapper: BVH32 closest-hit and any-hit traversal on Hopper.

``bvhw_intersect(table, o, d, t_max, any_hit=False, stackw=STACKW)``
keeps the signature and return dict of the reference's
``pathtracer_tpu/accel/bvhw.py::bvhw_intersect``. CUDA tensors go to the
hand-written kernel in ``csrc/bvhw.cu`` (one warp walks one ray, one lane
tests one child of a row); CPU tensors go to the plain PyTorch version
``accel/bvhw.bvhw_intersect``. There is no fallback
between the two: a CUDA input that the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from ...accel import bvhw as plain
from ...accel.bvhw import G_SLAB, STACKW, WW
from ..intersect import GAMMA2, GAMMA3, GAMMA5
from . import _build

SOURCE = "bvhw.cu"
# the launcher's signature (ops/cuda/_build.bind): table, o, d, t_max;
# rows, n, any_hit, stackw; g, g2, g3, g5; valid, t, tri, b, stream
SIGNATURES = {"bvhw": "ppppiiiiffffppppp"}

# kernel launches made by ``bvhw_intersect`` (CPU calls never count)
LAUNCHES = 0

_fns = None


def build(verbose: bool = False) -> str:
    """Compile csrc/bvhw.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
    return _fns


F32 = torch.float32


def _check(table, o, d, t_max):
    """Check an (R >= 2, 256) table, (N, 3) o and d and (N,) t_max, all
    f32. Returns (the CUDA device's index, or -1 for CPU tensors; N)."""
    try:  # the case a launch takes, in the fewest attribute reads
        dev, shape, tshape = table.get_device(), o.shape, table.shape
        if table.dtype is F32 and o.dtype is F32 and d.dtype is F32 \
                and t_max.dtype is F32 and table.is_cuda \
                and o.get_device() == dev and d.get_device() == dev \
                and t_max.get_device() == dev and table.is_contiguous() \
                and o.is_contiguous() and d.is_contiguous() \
                and t_max.is_contiguous() and len(shape) == 2 \
                and shape[1] == 3 and d.shape == shape \
                and t_max.shape == shape[:1] and len(tshape) == 2 \
                and tshape[1] == WW and tshape[0] >= 2:
            return dev, shape[0]
    except AttributeError:  # not a tensor: check raises for it
        pass
    dev = _build.check("bvhw_intersect", dict(table=table, o=o, d=d,
                                              t_max=t_max), F32)
    n = o.shape[0] if o.dim() == 2 else -1
    if o.dim() != 2 or o.shape[1] != 3 or tuple(d.shape) != (n, 3):
        raise ValueError(f"o, d must be (N, 3), got {tuple(o.shape)}, "
                         f"{tuple(d.shape)}")
    if tuple(t_max.shape) != (n,):
        raise ValueError(f"t_max must be ({n},), got {tuple(t_max.shape)}")
    if table.dim() != 2 or table.shape[1] != WW or table.shape[0] < 2:
        raise ValueError(f"table must be (R >= 2, {WW}), got "
                         f"{tuple(table.shape)}")
    return dev, n


def bvhw_intersect(table, o, d, t_max, any_hit: bool = False,
                   stackw: int = STACKW):
    """BVH32 traversal of every ray (accel/bvhw.py has the table layout).

    table: (R, 256) f32 from build_bvhw; o, d: (N, 3) f32; t_max: (N,) f32
    (lanes with t_max <= 0 are dead on entry); stackw: the stack depth,
    1..STACKW (the build depth suffices). Returns dict(valid (N,) bool,
    t (N,) (0 on a miss), tri (N,) i32 (0 on a miss), b (N, 3) (0 on a
    miss)) or, with any_hit, an (N,) bool tensor.
    """
    global LAUNCHES
    dev, n = _check(table, o, d, t_max)
    if not 1 <= stackw <= STACKW:
        raise ValueError(f"stackw must be in [1, {STACKW}], got {stackw}")
    if dev < 0:
        return plain.bvhw_intersect(table, o, d, t_max, any_hit, stackw)
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
            (_fns or _load())["bvhw"], "bvhw", dev, table.data_ptr(),
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), table.shape[0], n,
            int(bool(any_hit)), int(stackw), G_SLAB, GAMMA2, GAMMA3, GAMMA5,
            *outs)
        LAUNCHES += 1
    if any_hit:
        return valid
    return dict(valid=valid, t=t, tri=tri, b=b)
