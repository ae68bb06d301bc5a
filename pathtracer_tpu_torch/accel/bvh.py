"""Binary SAH BVH: host build, packed node rows, plain traversal.

Port of ``pathtracer_tpu/accel/bvh.py``: the 12-bucket SAH recursive build
with leaves of at most ``max_prims`` triangles and the flattened
depth-first node layout (interior nodes store their second child's index,
the first child follows them). Above 20,000 triangles the native C++
builder (``accel/cpp.py``) does the same build. The triangles are
reordered so each leaf's are contiguous; ``order`` is the permutation.

The binary tree is the input of the 32-wide collapse (``accel/bvhw.py``).
Its own traversal, ``bvh_intersect`` over the (M, 8) rows of
``_pack_nodes``, serves one route only, as in the reference: a scene whose
every triangle carries an alpha mask on the BVH route, where nothing is
split out and no 32-wide table is built. It tests the masks inline
(``_alpha_test_inline``, also the mask test of the dense alpha pass in
``ops/intersect.py``). It is plain PyTorch: the reference runs it in XLA,
not in a Pallas kernel.

Left out: ``offset_leaf_tris``, which the reference applies only to the
alpha subset's own binary tree (``bvh_alpha``, above 1,536 masked
triangles), a tree it never traverses because the subset's 32-wide table
(above 512) takes precedence; only that tree's ``order`` is used. And
``bvh_intersect_chunked``, a TPU scheduling knob.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..core import math as pm
from ..ops.intersect import _take3, watertight_hit_diag

N_BUCKETS = 12
STACK_DEPTH = 64
# the slab test's far-plane widening 1 + 2 gamma(3), as the exact f32
G_SLAB = float(np.float32(1.0) + np.float32(2.0) * pm.gamma(3))


@dataclasses.dataclass
class BVHArrays:
    """Flattened binary BVH as host numpy arrays (SoA LinearBVHNode)."""

    bounds_min: np.ndarray  # (M, 3) f32
    bounds_max: np.ndarray  # (M, 3) f32
    offset: np.ndarray  # (M,) i32: prims offset (leaf) or second child
    n_prims: np.ndarray  # (M,) i32, 0 for interior nodes
    axis: np.ndarray  # (M,) i32 split axis of interior nodes
    order: np.ndarray  # (F,) triangle permutation applied
    max_leaf: int


def build_bvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
              max_prims: int = 4, native: bool | None = None) -> BVHArrays:
    """12-bucket SAH build over triangle bounds (host).

    Uses the C++ builder when ``native`` (by default above 20,000
    triangles) and it compiles; otherwise the numpy build below.
    """
    if native is None:
        native = len(p0) > 20_000
    if native:
        from . import cpp
        if cpp.available():
            bmin, bmax, off, npr, ax, order = cpp.build(
                np.asarray(p0), np.asarray(p1), np.asarray(p2), max_prims)
            return BVHArrays(bounds_min=bmin, bounds_max=bmax, offset=off,
                             n_prims=npr, axis=ax, order=order,
                             max_leaf=max_prims)
    f = len(p0)
    lo = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    hi = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    centroid = 0.5 * (lo + hi)

    nb_min: list[np.ndarray] = []
    nb_max: list[np.ndarray] = []
    noffset: list[int] = []
    nprims: list[int] = []
    naxis: list[int] = []
    order: list[np.ndarray] = []
    n_ordered = 0

    def sa(e):
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def emit(b_lo, b_hi, off, np_, ax):
        nb_min.append(b_lo)
        nb_max.append(b_hi)
        noffset.append(off)
        nprims.append(np_)
        naxis.append(ax)
        return len(nb_min) - 1

    rec_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec_limit, 10_000 + f))

    def build(prims) -> int:
        nonlocal n_ordered
        b_lo = lo[prims].min(0)
        b_hi = hi[prims].max(0)

        def leaf():
            nonlocal n_ordered
            idx = emit(b_lo, b_hi, n_ordered, len(prims), 0)
            order.append(prims)
            n_ordered += len(prims)
            return idx

        if len(prims) <= max_prims:
            return leaf()
        c = centroid[prims]
        c_lo, c_hi = c.min(0), c.max(0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        # coincident centroids must still split (equal-count median below):
        # a leaf above max_prims would not fit its leaf row
        best_cost, best_split = np.inf, -1
        if extent[axis] > 0:
            scaled = np.minimum(((c[:, axis] - c_lo[axis]) / extent[axis]
                                 * N_BUCKETS).astype(np.int32), N_BUCKETS - 1)
            bl, bh = lo[prims], hi[prims]
            for split in range(N_BUCKETS - 1):
                left = scaled <= split
                nl = int(left.sum())
                nr = len(prims) - nl
                if nl == 0 or nr == 0:
                    continue
                cost = 0.125 + (nl * sa(bh[left].max(0) - bl[left].min(0)) +
                                nr * sa(bh[~left].max(0) - bl[~left].min(0))) \
                    / max(sa(b_hi - b_lo), 1e-20)
                if cost < best_cost:
                    best_cost, best_split = cost, split
        if best_split < 0:
            med = np.argsort(c[:, axis], kind="stable")
            half = len(prims) // 2
            li, ri = prims[med[:half]], prims[med[half:]]
        else:
            mask = scaled <= best_split
            li, ri = prims[mask], prims[~mask]

        node = emit(b_lo, b_hi, 0, 0, axis)
        left_idx = build(li)
        if left_idx != node + 1:
            raise AssertionError("first child must follow its parent")
        noffset[node] = build(ri)
        return node

    try:
        build(np.arange(f))
    finally:
        sys.setrecursionlimit(rec_limit)
    return BVHArrays(
        bounds_min=np.stack(nb_min), bounds_max=np.stack(nb_max),
        offset=np.asarray(noffset, np.int32),
        n_prims=np.asarray(nprims, np.int32),
        axis=np.asarray(naxis, np.int32),
        order=np.concatenate(order) if order else np.arange(0),
        max_leaf=max_prims)


def _pack_nodes(bmin, bmax, off, npr, ax) -> np.ndarray:
    """(M, 8) f32 node rows [bmin bmax offset meta], meta = n_prims * 4 +
    axis, host numpy (the fields of ``BVHArrays``); the integer fields
    are exact in f32 (node counts below 2^24)."""
    bmin = np.asarray(bmin, np.float32)
    if bmin.shape[0] >= (1 << 24):
        raise ValueError("node offsets must stay exact in f32")
    meta = np.asarray(npr, np.int64) * 4 + np.asarray(ax, np.int64)
    return np.concatenate([
        bmin, np.asarray(bmax, np.float32),
        np.asarray(off, np.float32)[:, None],
        meta.astype(np.float32)[:, None]], axis=1)


def _slab_test(bmin, bmax, o, inv_d, t_best):
    """Robust AABB slab test with the far plane widened by 1 + 2 gamma(3);
    an axis whose slab gives NaN (0 * inf) does not constrain."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    nan_ax = torch.isnan(t0) | torch.isnan(t1)
    t_near = torch.where(nan_ax, -torch.inf, torch.minimum(t0, t1))
    t_far = torch.where(nan_ax, torch.inf, torch.maximum(t0, t1) * G_SLAB)
    tn = torch.amax(t_near, dim=-1)
    tf = torch.amin(t_far, dim=-1)
    return (tn <= tf) & (tf > 0.0) & (tn < t_best)


def _alpha_test_inline(alpha_pack, alpha_texels, pid, b):
    """Level-0 bilinear mask test of candidate triangles ``pid`` (N,) at
    barycentrics ``b`` (N, 3): True where the candidate SURVIVES, False
    where it carries a mask whose interpolated alpha is exactly 0. Pool
    column 0 only, with the pool's wrap rules (repeat, clamp, black)."""
    from ..scene.scene import (AP_BASE, AP_FLAG, AP_H, AP_OUOV, AP_SUSV,
                               AP_UV0, AP_UV1, AP_UV2, AP_W, AP_WRAP)
    from ..scene.texture import WRAP_CLAMP, WRAP_REPEAT
    arow = alpha_pack[pid.long()]
    flag = arow[:, AP_FLAG] > 0.5
    b0, b1, b2 = b[..., 0:1], b[..., 1:2], b[..., 2:3]
    uv = b0 * arow[:, AP_UV0] + b1 * arow[:, AP_UV1] + b2 * arow[:, AP_UV2]
    st = uv * arow[:, AP_SUSV] + arow[:, AP_OUOV]
    w = arow[:, AP_W]
    h = arow[:, AP_H]
    wrap = arow[:, AP_WRAP].to(torch.int32)
    base = arow[:, AP_BASE].contiguous().view(torch.int32).long()
    s = st[..., 0] * w - 0.5
    t = st[..., 1] * h - 0.5
    s0f = torch.floor(s)
    t0f = torch.floor(t)
    ds = s - s0f
    dt = t - t0f
    s0 = s0f.to(torch.int32)
    t0 = t0f.to(torch.int32)
    wi = w.to(torch.int32)
    hi = h.to(torch.int32)
    repeat = wrap == WRAP_REPEAT
    black = ~repeat & (wrap != WRAP_CLAMP)

    def texel(si, ti):
        # floor-mod, as jnp.mod on int32; the divisor is at least 1 on
        # every row (a masked row's level 0, else texture 0's)
        s_w = torch.where(repeat, torch.remainder(si, torch.clamp_min(wi, 1)),
                          torch.minimum(torch.clamp_min(si, 0), wi - 1))
        t_w = torch.where(repeat, torch.remainder(ti, torch.clamp_min(hi, 1)),
                          torch.minimum(torch.clamp_min(ti, 0), hi - 1))
        outside = (si < 0) | (si >= wi) | (ti < 0) | (ti >= hi)
        v = alpha_texels[base + (t_w * wi + s_w).long()]
        return torch.where(black & outside, 0.0, v)

    a = (texel(s0, t0) * (1 - ds) * (1 - dt)
         + texel(s0, t0 + 1) * (1 - ds) * dt
         + texel(s0 + 1, t0) * ds * (1 - dt)
         + texel(s0 + 1, t0 + 1) * ds * dt)
    return ~(flag & (a == 0.0))


def bvh_intersect(nodes, max_leaf: int, tri_pack, o, d, t_max,
                  any_hit: bool = False, alpha_pack=None, alpha_texels=None):
    """Lane-parallel traversal of the binary tree (plain PyTorch).

    nodes: (M, 8) rows of ``_pack_nodes``; max_leaf: the build's leaf size;
    tri_pack: (F, 12) [p0 p1 p2 pad] rows in the tree's order;
    alpha_pack / alpha_texels (``scene.pack_alpha_tri``) turn on the
    inline mask test. Every lane pops one node a step; interior hits push
    the far child first, leaf hits test up to ``max_leaf`` triangles.
    Lanes whose t_max is not > 0 test nothing. Returns dict(valid, t (0 on
    a miss), tri, b) or, with ``any_hit``, (N,) bool.
    """
    n = o.shape[0]
    dev = o.device
    inv_d = 1.0 / d
    neg = d < 0.0
    rows = torch.arange(n, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    # the root sits at slot 0; a lane whose t_max is not > 0 can hit
    # nothing, so it starts with an empty stack
    sp = (t_max > 0.0).to(torch.int32)
    t_best = t_max
    tri = torch.zeros((n,), dtype=torch.int32, device=dev)
    b = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    while True:
        live = sp > 0
        if any_hit:
            live = live & ~found
        if not bool(live.any()):
            break
        sp = torch.where(live, sp - 1, sp)
        node = stack[rows, torch.clamp_max(sp, STACK_DEPTH - 1).long()]
        node = torch.where(live, node, 0)
        nrow = nodes[node.long()]  # one packed row a pop
        near = _slab_test(nrow[:, 0:3], nrow[:, 3:6], o, inv_d,
                          t_best) & live
        off = nrow[:, 6].to(torch.int32)
        meta = nrow[:, 7].to(torch.int32)
        n_p = meta >> 2
        axis = meta & 3
        is_leaf = n_p > 0

        leaf_hit = near & is_leaf
        for k in range(max_leaf):
            in_leaf = leaf_hit & (k < n_p)
            pid = torch.where(in_leaf, off + k, 0)
            trow = tri_pack[pid.long()]
            t_k, b_k, hit_k = watertight_hit_diag(
                o, d, t_best, trow[:, 0:3], trow[:, 3:6], trow[:, 6:9])
            take = in_leaf & hit_k
            if alpha_pack is not None:
                take = take & _alpha_test_inline(alpha_pack, alpha_texels,
                                                 pid, b_k)
            t_best = torch.where(take, t_k, t_best)
            tri = torch.where(take, pid, tri)
            b = torch.where(take[:, None], b_k, b)
            found = found | take

        # interior: push the far child first so the near one pops first
        push = near & ~is_leaf
        dir_neg = _take3(neg, axis)
        child_near = torch.where(dir_neg, off, node + 1)
        child_far = torch.where(dir_neg, node + 1, off)
        for child in (child_far, child_near):
            slot = torch.clamp_max(sp, STACK_DEPTH - 1).long()
            stack = stack.index_put(
                (rows, slot), torch.where(push, child, stack[rows, slot]))
            sp = torch.where(push, sp + 1, sp)

    if any_hit:
        return found
    return dict(valid=found, t=torch.where(found, t_best, 0.0), tri=tri,
                b=b)
