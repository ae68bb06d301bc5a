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

import ctypes

import torch

from ...accel import bvhw as plain
from ...accel.bvhw import G_SLAB, STACKW, WW
from ..intersect import GAMMA2, GAMMA3, GAMMA5
from . import _build

SOURCE = "bvhw.cu"
# the C launcher's arguments: table, o, d, t_max; rows, n, any_hit, stackw;
# g, g2, g3, g5; valid, t, tri, b, stream
SIGNATURES = {"pt_bvhw_launch": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 5)}

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


def _check(table, o, d, t_max):
    dev = _build.check("bvhw_intersect", dict(table=table, o=o, d=d,
                                              t_max=t_max), torch.float32)
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
    if not o.is_cuda:
        return plain.bvhw_intersect(table, o, d, t_max, any_hit, stackw)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    t = tri = b = None
    if not any_hit:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        b = torch.empty(n, 3, dtype=torch.float32, device=dev)
    if n > 0:
        outs = [valid.data_ptr()] + ([None] * 3 if any_hit else [
            t.data_ptr(), tri.data_ptr(), b.data_ptr()])
        _build.launch(
            _load()["pt_bvhw_launch"], "bvhw", dev, table.data_ptr(),
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), table.shape[0], n,
            int(bool(any_hit)), int(stackw), G_SLAB, GAMMA2, GAMMA3, GAMMA5,
            *outs)
        LAUNCHES += 1
    if any_hit:
        return valid
    return dict(valid=valid, t=t, tri=tri, b=b)
