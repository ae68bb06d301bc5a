"""32-wide BVH with 256-float rows: host collapse and plain traversal.

Port of ``pathtracer_tpu/accel/bvhw.py``. The host half (``build_bvhw``,
``bvhw_from_binary``) is numpy, line for line, and gives the reference's
table bit for bit. The device half, ``bvhw_intersect``, is the plain
PyTorch version of kernel K2 (``ops/cuda/bvhw_cu.py`` / ``csrc/bvhw.cu``):
a lockstep ``while live.any()`` loop over SoA lane state, one (N, 256) row
gather per step.

Layout (one (R, 256) f32 table, self-describing rows):

  INTERIOR row: 32 children's slabs component-major
      [bminx(32) bminy(32) bminz(32) bmaxx(32) bmaxy(32) bmaxz(32)] = 192
      [192] base child row, [193] occupancy bits 0-15, [194] bits 16-31
      (children are stored compactly in ascending-slot order: child row =
      base + popcount(occ & ((1 << slot) - 1))); empty slots hold +inf
      boxes; [255] kind = 0
  LEAF row (at most 25 inline triangles, component-major):
      [25*c + j] component c of triangle j, c in (p0x p0y p0z p1x .. p2z);
      [225+j] global triangle id (-1 pad); [255] kind = 1

Front-to-back order uses a 5-bit slot code: bits [4,3,2] = the child
centroid's octant against the node center (x, y, z), bits [1,0] = x / y
against the quartile plane of the child's own half. Every bit is a "which
side of an axis plane" predicate, so one per-ray mask (sign of d.x on bits
4 and 1, d.y on 3 and 0, d.z on 2) XOR-flips the code into approximate
near-to-far order; the traversal builds each node's hit mask in that
permuted bit order, so the next child is the lowest set bit. Colliding
children take the free slot at the smallest XOR distance.

The component-major rows are made for one lane per child: kernel K2 gives a
ray a warp, lane l tests slot l ^ mask5, and each of its six slab words
(``row[32 c + slot]``) is, across the 32 lanes, one 128-byte line; the
lanes' ballot is the permuted hit mask. A leaf's nine vertex words
``row[25 c + j]`` are likewise consecutive across lanes j < 25.

Left out, as TPU scheduling knobs: the interleaved and chunked loops,
the sequential leaf chain and the per-lane step counter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as pm
from ..ops.intersect import watertight_cols_pre, watertight_hit_cols
from .bvh import build_bvh

BW = 32           # branching
WW = 256          # row width (f32)
LEAFW = 25        # max inline triangles per leaf row
STACKW = 10       # the collapse requires depth < STACKW

# the slab test's far-plane widening 1 + 2 gamma(3), as the exact f32
G_SLAB = float(np.float32(1.0) + np.float32(2.0) * pm.gamma(3))

_U32 = 0xFFFFFFFF


def build_bvhw(p0, p1, p2, max_leaf: int = 4):
    """Triangle soup -> (table (R, 256) f32, order (F,), depth).

    Builds the binary SAH tree and collapses it. Leaf rows index the
    REORDERED arrays (apply ``order`` first).
    """
    b = build_bvh(np.asarray(p0), np.asarray(p1), np.asarray(p2),
                  min(max_leaf, LEAFW))
    p0r = np.asarray(p0, np.float32)[b.order]
    p1r = np.asarray(p1, np.float32)[b.order]
    p2r = np.asarray(p2, np.float32)[b.order]
    table, depth = bvhw_from_binary(b, p0r, p1r, p2r)
    return table, b.order, depth


def bvhw_from_binary(b, p0r, p1r, p2r):
    """Collapse a built binary BVH (accel/bvh.BVHArrays) into the 32-wide
    row table. p0r/p1r/p2r are the triangle vertices already permuted into
    ``b.order``. Returns (table (R, 256) f32, depth)."""
    bmin = np.asarray(b.bounds_min, np.float32)
    bmax = np.asarray(b.bounds_max, np.float32)
    off = np.asarray(b.offset, np.int64)
    npr = np.asarray(b.n_prims, np.int64)
    p0r = np.asarray(p0r, np.float32)
    p1r = np.asarray(p1r, np.float32)
    p2r = np.asarray(p2r, np.float32)
    if npr.max(initial=0) > LEAFW:
        raise ValueError("binary leaves must fit a leaf row")
    ext = np.maximum(bmax - bmin, 0.0)
    sa = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
          + ext[:, 2] * ext[:, 0])
    # subtree (start, count) by pre-order flattening (python lists: numpy
    # scalar indexing in this loop is ~10x slower)
    m = len(bmin)
    npr_l = npr.tolist()
    off_l = off.tolist()
    subtree_n = [0] * m
    subtree_s = [0] * m
    for i in range(m - 1, -1, -1):
        if npr_l[i] > 0:
            subtree_n[i] = npr_l[i]
            subtree_s[i] = off_l[i]
        else:
            subtree_n[i] = subtree_n[i + 1] + subtree_n[off_l[i]]
            subtree_s[i] = subtree_s[i + 1]
    subtree_n = np.asarray(subtree_n, np.int64)
    subtree_s = np.asarray(subtree_s, np.int64)

    def leaf_rows_vec(nodes: np.ndarray) -> np.ndarray:
        """(K,) node ids (subtree_n <= LEAFW) -> (K, 256) leaf rows."""
        k = len(nodes)
        r = np.zeros((k, WW), np.float32)
        o = subtree_s[nodes]
        cnt = subtree_n[nodes]
        for j in range(LEAFW):
            have = j < cnt
            tri = np.where(have, o + j, 0)
            for c in range(9):
                src = (p0r, p1r, p2r)[c // 3]
                r[:, LEAFW * c + j] = np.where(have, src[tri, c % 3], 0.0)
            r[:, 9 * LEAFW + j] = np.where(have, tri.astype(np.float32), -1.0)
        r[:, 255] = 1.0
        return r

    idx_chunks: list[np.ndarray] = []
    val_chunks: list[np.ndarray] = []
    alloc = 1  # row 0 = root
    depth = 1

    if subtree_n[0] <= LEAFW:
        # the whole scene fits one leaf: a root with a single child
        r = np.zeros(WW, np.float32)
        r[0:192] = np.inf
        r[0], r[32], r[64] = bmin[0]
        r[96], r[128], r[160] = bmax[0]
        r[192] = np.float32(alloc)
        r[193] = 1.0  # occupancy: slot 0 only
        idx_chunks.append(np.asarray([0, alloc], np.int64))
        val_chunks.append(np.stack([r, leaf_rows_vec(np.asarray([0]))[0]]))
        alloc += 1
    else:
        frontier = np.asarray([0], np.int64)       # binary node ids
        frontier_rows = np.asarray([0], np.int64)  # their table rows
        while len(frontier):
            fn = len(frontier)
            ar = np.arange(fn)
            # split each node into <= 32 clusters: repeatedly split the
            # splittable cluster (interior subtree > LEAFW tris) with the
            # largest surface area. cl: (F, 32), -1 = empty
            cl = np.full((fn, BW), -1, np.int64)
            cl[:, 0] = frontier
            cnt = np.ones(fn, np.int64)
            for _ in range(BW - 1):
                cls = np.clip(cl, 0, None)
                can = (cl >= 0) & (subtree_n[cls] > LEAFW)
                sa_c = np.where(can, sa[cls], -np.inf)
                j = np.argmax(sa_c, axis=1)
                do = can[ar, j] & (cnt < BW)
                node = cl[ar, j]
                sel = ar[do]
                cl[sel, j[do]] = node[do] + 1        # first child
                cl[sel, cnt[do]] = off[node[do]]     # second child
                cnt[do] += 1
            # contested slot codes go to the child likeliest to be hit:
            # assign in descending surface-area order
            sa_cl = np.where(cl >= 0, sa[np.clip(cl, 0, None)], -np.inf)
            cl = np.take_along_axis(cl, np.argsort(-sa_cl, axis=1), axis=1)
            have = cl >= 0
            cls = np.clip(cl, 0, None)
            # 5-bit slot codes (module docstring); colliding children take
            # the free slot with the smallest XOR distance (the k-th
            # choice for preference p is p XOR k)
            centers = 0.5 * (bmin[cls] + bmax[cls])          # (F, 32, 3)
            nc = 0.5 * (bmin[frontier] + bmax[frontier])     # (F, 3)
            next_ = (bmax[frontier] - bmin[frontier])        # (F, 3)
            hx = centers[..., 0] > nc[:, None, 0]
            hy = centers[..., 1] > nc[:, None, 1]
            hz = centers[..., 2] > nc[:, None, 2]
            qx = nc[:, None, 0] + np.where(hx, 0.25, -0.25) * next_[:, None, 0]
            qy = nc[:, None, 1] + np.where(hy, 0.25, -0.25) * next_[:, None, 1]
            prefs = (hx * 16 + hy * 8 + hz * 4
                     + (centers[..., 0] > qx) * 2
                     + (centers[..., 1] > qy)).astype(np.int64)
            taken = np.zeros((fn, BW), bool)
            slots = np.full((fn, BW), -1, np.int64)
            for i in range(BW):
                assigned = np.full(fn, -1, np.int64)
                for k in range(BW):
                    s = prefs[:, i] ^ k
                    free = (assigned < 0) & have[:, i] & ~taken[ar, s]
                    assigned = np.where(free, s, assigned)
                    taken[ar[free], s[free]] = True
                slots[:, i] = assigned
            # this level's interior rows (children allocated compactly in
            # ascending-slot order; occupancy mask stored)
            sel = slots[have]
            src = cl[have]
            fi = np.broadcast_to(ar[:, None], (fn, BW))[have]
            occm = np.zeros((fn, BW), bool)
            occm[fi, sel] = True
            n_child = occm.sum(axis=1)
            bases = alloc + np.concatenate(
                [[0], np.cumsum(n_child)[:-1]]).astype(np.int64)
            alloc += int(n_child.sum())
            rank = np.cumsum(occm, axis=1) - occm  # exclusive by-slot rank
            occ_bits = (occm.astype(np.uint64)
                        << np.arange(BW, dtype=np.uint64)).sum(axis=1)
            rows_i = np.zeros((fn, WW), np.float32)
            rows_i[:, 0:192] = np.inf  # empty slots: +inf boxes
            for comp, arr in enumerate((bmin[src][:, 0], bmin[src][:, 1],
                                        bmin[src][:, 2], bmax[src][:, 0],
                                        bmax[src][:, 1], bmax[src][:, 2])):
                rows_i[fi, BW * comp + sel] = arr
            rows_i[:, 192] = bases.astype(np.float32)
            rows_i[:, 193] = (occ_bits & 0xFFFF).astype(np.float32)
            rows_i[:, 194] = (occ_bits >> 16).astype(np.float32)
            idx_chunks.append(frontier_rows)
            val_chunks.append(rows_i)
            # children: leaves are emitted now, interiors join the frontier
            child_rows = bases[fi] + rank[fi, sel]
            is_leaf_c = subtree_n[src] <= LEAFW
            leaf_nodes = src[is_leaf_c]
            if len(leaf_nodes):
                idx_chunks.append(child_rows[is_leaf_c])
                val_chunks.append(leaf_rows_vec(leaf_nodes))
            frontier = src[~is_leaf_c]
            frontier_rows = child_rows[~is_leaf_c]
            if len(frontier):
                depth += 1

    table = np.zeros((alloc, WW), np.float32)
    table[np.concatenate(idx_chunks)] = np.concatenate(val_chunks)
    if table.shape[0] >= (1 << 24) or len(p0r) >= (1 << 24):
        raise ValueError("row refs and triangle ids must stay exact in f32")
    if depth >= STACKW:
        raise ValueError(f"BVH32 depth {depth} >= {STACKW}")
    return table, depth


# --------------------------------------------------------------------------
# plain traversal (the plain version of kernel K2)


def _popcount32(x):
    """Set bits of each int64 element of [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def _slab32(row, oc96, ic96, t_best):
    """Robust slab test of the 32 child boxes of interior rows: (N, 32)
    bool. The far plane is widened by 1 + 2 gamma(3); an axis whose slab
    gives NaN (0 * inf) does not constrain."""
    lo = (row[:, 0:96] - oc96) * ic96
    hi = (row[:, 96:192] - oc96) * ic96
    nan_ax = torch.isnan(lo) | torch.isnan(hi)
    tn96 = torch.where(nan_ax, -torch.inf, torch.minimum(lo, hi))
    tf96 = torch.where(nan_ax, torch.inf, torch.maximum(lo, hi) * G_SLAB)
    tn = torch.maximum(torch.maximum(tn96[:, 0:32], tn96[:, 32:64]),
                       tn96[:, 64:96])
    tf = torch.minimum(torch.minimum(tf96[:, 0:32], tf96[:, 32:64]),
                       tf96[:, 64:96])
    return (tn <= tf) & (tf > 0.0) & (tn < t_best[:, None])


def _hit_mask(hits, bitvals):
    """(N, 32) slot hits -> (N,) permuted-order bit mask."""
    return torch.sum(torch.where(hits, bitvals, 0), dim=1)


def _occupancy(row):
    return row[:, 193].long() | (row[:, 194].long() << 16)


def _leaf_closest(pre, t_best, row, lact, st):
    """The 25 inline tests of a leaf row, all against the bound as it
    stood on entry to the leaf; the first minimum column wins."""
    c9 = [row[:, LEAFW * k:LEAFW * (k + 1)] for k in range(9)]
    ids = row[:, 9 * LEAFW:10 * LEAFW].long()
    t_a, b0_a, b1_a, b2_a, h_a = watertight_hit_cols(
        pre, t_best[:, None], c9)
    h_a = h_a & (ids >= 0) & lact[:, None]
    t_min, col = torch.min(torch.where(h_a, t_a, torch.inf), dim=1)
    any_h = t_min < torch.inf
    col = col[:, None]
    st["tri"] = torch.where(any_h, ids.gather(1, col)[:, 0].int(),
                            st["tri"])
    for key, b_a in (("b0", b0_a), ("b1", b1_a), ("b2", b2_a)):
        st[key] = torch.where(any_h, b_a.gather(1, col)[:, 0], st[key])
    st["found"] = st["found"] | any_h
    return torch.where(any_h, t_min, t_best)


def _leaf_anyhit(pre, t_max, row, lact, found):
    c9 = [row[:, LEAFW * k:LEAFW * (k + 1)] for k in range(9)]
    ids = row[:, 9 * LEAFW:10 * LEAFW]
    h_a = watertight_hit_cols(pre, t_max[:, None], c9)[4]
    return found | (lact & torch.any(h_a & (ids >= 0), dim=1))


def bvhw_intersect(table, o, d, t_max, any_hit: bool = False,
                   stackw: int = STACKW, row_counts: dict | None = None):
    """Lockstep BVH32 traversal, one (N, 256) row gather per step.

    table: (R, 256) f32 from build_bvhw, on the rays' device; o, d: (N, 3);
    t_max: (N,), lanes with t_max <= 0 are dead on entry. stackw: rows of
    the short stack (descents push at most depth - 1 times, so the build
    depth suffices; a deeper descent drops the oldest entry, as in the
    reference). Returns dict(valid, t (0 on a miss), tri (0 on a miss),
    b (0 on a miss)) or, with any_hit, an (N,) bool tensor. Where
    ``row_counts`` is given, the work the rays need on these inputs is
    added to it: "interior" and "leaf" rows visited (the root's slab test
    included), "slabs", the occupied children of those interior rows, and
    "triangles", the real (not pad) triangles of those leaf rows.
    """
    if not 1 <= stackw <= STACKW:
        raise ValueError(f"stackw must be in [1, {STACKW}], got {stackw}")
    n = o.shape[0]
    dev = o.device
    inv_d = torch.reciprocal(d)
    # per-ray 5-bit slot-code mask; the hit mask is built in PERMUTED
    # order (bit slot ^ mask5), so the lowest set bit is the nearest child
    mask5 = ((d[:, 0] < 0).long() * 18 + (d[:, 1] < 0).long() * 9
             + (d[:, 2] < 0).long() * 4)
    perm = torch.arange(BW, device=dev)[None, :] ^ mask5[:, None]
    bitvals = torch.bitwise_left_shift(torch.ones_like(perm), perm)
    # each ray component broadcast to its row block of 32 slab values
    oc96 = o[:, :, None].expand(n, 3, BW).reshape(n, 3 * BW)
    ic96 = inv_d[:, :, None].expand(n, 3, BW).reshape(n, 3 * BW)
    pre = {k: v[:, None] for k, v in watertight_cols_pre(o, d).items()}

    root = table[0:1]
    cur_mask = _hit_mask(_slab32(root, oc96, ic96, t_max), bitvals)
    cur_mask = torch.where(t_max > 0.0, cur_mask, 0)  # dead on entry
    if row_counts is not None:  # interior, leaf rows; slabs, triangles
        live0 = (t_max > 0.0).sum()
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        visits = [live0, zero, live0 * _popcount32(_occupancy(root))[0],
                  zero]
    cur_base = root[:, 192].long().expand(n)
    cur_occ = _occupancy(root).expand(n)
    zeros_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    stack = torch.zeros((3, stackw, n), dtype=torch.int64, device=dev)
    sp = zeros_i
    t_best = t_max
    st = dict(tri=zeros_i.to(torch.int32),
              b0=torch.zeros_like(t_max), b1=torch.zeros_like(t_max),
              b2=torch.zeros_like(t_max),
              found=torch.zeros((n,), dtype=torch.bool, device=dev))

    while True:
        live = (cur_mask != 0) | (sp > 0)
        if any_hit:
            live = live & ~st["found"]
        if not bool(live.any()):
            break
        # pop (LIFO, top at stack row 0)
        do_pop = (cur_mask == 0) & (sp > 0) & live
        cur_base = torch.where(do_pop, stack[0, 0], cur_base)
        cur_mask = torch.where(do_pop, stack[1, 0], cur_mask)
        cur_occ = torch.where(do_pop, stack[2, 0], cur_occ)
        stack = torch.where(do_pop[None, None], torch.cat(
            [stack[:, 1:], torch.zeros_like(stack[:, :1])], dim=1), stack)
        sp = torch.where(do_pop, sp - 1, sp)
        act = live & (cur_mask != 0)

        # next child: lowest set permuted bit, undone to its slot
        low = cur_mask & -cur_mask
        p = torch.clamp_max(_popcount32((low - 1) & _U32), 31)
        slot = p ^ mask5
        cur_mask = cur_mask & (cur_mask - 1)
        rank = _popcount32(cur_occ & (torch.bitwise_left_shift(
            torch.ones_like(slot), slot) - 1))
        child = torch.where(act, cur_base + rank, 0)

        row = table[child]  # the one row gather per step
        is_leaf = row[:, 255] > 0.5
        lact = act & is_leaf
        if any_hit:
            st["found"] = _leaf_anyhit(pre, t_max, row, lact, st["found"])
        else:
            t_best = _leaf_closest(pre, t_best, row, lact, st)

        # interior: slab-test the 32 grandchildren, descend
        iact = act & ~is_leaf
        if row_counts is not None:
            real = (row[:, 9 * LEAFW:10 * LEAFW] >= 0).sum(dim=1)
            visits = [visits[0] + iact.sum(), visits[1] + lact.sum(),
                      visits[2] + (_popcount32(_occupancy(row)) * iact).sum(),
                      visits[3] + (real * lact).sum()]
        new_mask = _hit_mask(_slab32(row, oc96, ic96, t_best)
                             & iact[:, None], bitvals)
        descend = iact & (new_mask != 0)
        push = descend & (cur_mask != 0)
        top = torch.stack([cur_base, cur_mask, cur_occ])[:, None]
        stack = torch.where(push[None, None],
                            torch.cat([top, stack[:, :-1]], dim=1), stack)
        sp = torch.where(push, sp + 1, sp)
        cur_base = torch.where(descend, row[:, 192].long(), cur_base)
        cur_mask = torch.where(descend, new_mask, cur_mask)
        cur_occ = torch.where(descend, _occupancy(row), cur_occ)

    if row_counts is not None:
        for key, v in zip(("interior", "leaf", "slabs", "triangles"),
                          visits):
            row_counts[key] = row_counts.get(key, 0) + int(v)
    if any_hit:
        return st["found"]
    valid = st["found"]
    return dict(valid=valid, t=torch.where(valid, t_best, 0.0),
                tri=st["tri"],
                b=torch.stack([st["b0"], st["b1"], st["b2"]], dim=-1))
