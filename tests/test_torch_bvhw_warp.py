"""A CPU model of kernel K2's algorithm (``csrc/bvhw.cu``): one warp walks
one ray, one lane tests one child.

The model is test code, not a second plain version: it walks ray by ray
with the 32 lanes as a tensor axis and does what the kernel's warp does.
Lane l tests slot ``l ^ mask5`` of an interior row and the ballot of the
lanes' predicates is the node's hit mask; lane j < 25 tests column j of a
leaf row and the winner is the smallest (t, column), t compared through
its bits as an unsigned integer; cursor and stack are single values, stack
entry k held by "lane" k, a push past ``stackw`` entries overwriting the
oldest. Everything must equal the plain traversal
``accel/bvhw.bvhw_intersect`` bit for bit (``torch.equal``): ``valid``,
``tri``, ``t``, ``b`` and the any-hit flags, exact ties and stacks
shallower than the tree included.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.accel import bvhw as pbvhw
from pathtracer_tpu_torch.accel.bvhw import BW, LEAFW
from pathtracer_tpu_torch.ops.intersect import (watertight_cols_pre,
                                                watertight_hit_cols)

torch.set_num_threads(1)

LANES = torch.arange(BW)
INF_BITS = 0x7F800000


def _soup(rng, f, spread=4.0, size=0.4):
    c = (rng.random((f, 1, 3)) * 2 - 1) * spread
    return (c + (rng.random((f, 3, 3)) * 2 - 1) * size).astype(np.float32)


def _rays(rng, n, tri, spread=6.0):
    """Rays from inside and around the soup ``tri`` (F, 3, 3), every other
    one aimed at a triangle; a quarter get a finite t_max, some are dead
    (t_max = 0) and some axis-parallel (1 / d = inf)."""
    o = ((rng.random((n, 3)) * 2 - 1) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = tri[rng.integers(0, len(tri), n)].mean(axis=1)
    d[::2] = (aim - o)[::2]
    d[::17, 1:] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.25, rng.uniform(0.5, 6.0, n),
                     np.inf).astype(np.float32)
    t_max[::13] = 0.0
    return torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max)


def _scene(name):
    """(table, depth, soup) of a named small scene. "twins" holds every
    triangle twice, so every hit is an exact tie inside one leaf or across
    two; "deep" adds a dense cluster of small triangles, which the 32-wide
    collapse keeps whole at the root: a table of depth 3."""
    f = dict(one=1, few=5, leaf=26, mid=600, big=3000, twins=300,
             deep=600)[name]
    rng = np.random.default_rng(f)
    tri = _soup(rng, f)
    if name == "twins":
        tri = np.concatenate([tri, tri])
    if name == "deep":
        tri = np.concatenate([tri, _soup(rng, 800, 0.3, 0.02) + np.float32(1)])
    table, _, depth = pbvhw.build_bvhw(tri[:, 0], tri[:, 1], tri[:, 2])
    return torch.as_tensor(table), depth, tri


def _ballot(pred):
    """The 32 lanes' predicates packed as __ballot_sync packs them."""
    return int((pred.long() << LANES).sum())


def _lane_slab_pred(row, o, inv_d, mask5, t_best):
    """Lane l's slab predicate on slot l ^ mask5 of interior ``row``."""
    s = LANES ^ mask5
    tn = torch.full((BW,), -torch.inf)
    tf = torch.full((BW,), torch.inf)
    for ax in range(3):
        lo = (row[BW * ax + s] - o[ax]) * inv_d[ax]
        hi = (row[BW * (3 + ax) + s] - o[ax]) * inv_d[ax]
        nan_ax = torch.isnan(lo) | torch.isnan(hi)
        tn = torch.maximum(tn, torch.where(nan_ax, -torch.inf,
                                           torch.minimum(lo, hi)))
        tf = torch.minimum(tf, torch.where(
            nan_ax, torch.inf, torch.maximum(lo, hi) * pbvhw.G_SLAB))
    return (tn <= tf) & (tf > 0.0) & (tn < t_best)


def _lane_leaf(row, pre, bound):
    """Lanes j < 25 test column j of leaf ``row``: (hit (32,), t bits as
    unsigned (32,), ids (32,), b (32, 3)); lanes 25..31 never hit."""
    c9 = [row[LEAFW * k:LEAFW * (k + 1)][None] for k in range(9)]
    t, b0, b1, b2, h = watertight_hit_cols(pre, bound.reshape(1, 1), c9)
    ids = row[9 * LEAFW:10 * LEAFW].long()
    pad = BW - LEAFW
    hit = torch.cat([h[0] & (ids >= 0), torch.zeros(pad, dtype=torch.bool)])
    t = torch.cat([t[0], torch.full((pad,), torch.inf)])
    bits = t.view(torch.int32).long() & 0xFFFFFFFF
    b = torch.cat([torch.stack([b0[0], b1[0], b2[0]], dim=-1),
                   torch.zeros(pad, 3)])
    return hit, bits, torch.cat([ids, torch.full((pad,), -1)]), t, b


def _lex_min(hit, bits):
    """(found, winning lane): the smallest t by its unsigned bits, then the
    lowest lane holding it (__reduce_min_sync, then __ffs of a ballot)."""
    keyed = torch.where(hit, bits, INF_BITS)
    low = int(keyed.min())
    if low >= INF_BITS:
        return False, -1
    ballot = _ballot(hit & (keyed == low))
    return True, (ballot & -ballot).bit_length() - 1


def warp_traverse(table, o, d, t_max, any_hit=False, stackw=pbvhw.STACKW):
    """The kernel's walk, one ray at a time."""
    n = o.shape[0]
    rows = table.shape[0]
    valid = torch.zeros(n, dtype=torch.bool)
    t_out = torch.zeros(n)
    tri_out = torch.zeros(n, dtype=torch.int32)
    b_out = torch.zeros(n, 3)
    root = table[0]
    root_base = int(root[192])
    root_occ = int(root[193]) | (int(root[194]) << 16)
    for i in range(n):
        tm = t_max[i]
        if not bool(tm > 0.0):  # dead on entry: one bit of the live ballot
            continue
        oi, di = o[i], d[i]
        inv_d = torch.reciprocal(di)
        mask5 = (18 * int(di[0] < 0) + 9 * int(di[1] < 0)
                 + 4 * int(di[2] < 0))
        pre = {k: v[:, None] for k, v in
               watertight_cols_pre(oi[None], di[None]).items()}
        t_best, best_tri, bb, found = tm, 0, torch.zeros(3), False
        cur_mask = _ballot(_lane_slab_pred(root, oi, inv_d, mask5, tm))
        cur_base, cur_occ = root_base, root_occ
        st = [None] * BW  # entry k in "lane" k
        sp = kept = steps = 0
        while True:
            if cur_mask == 0:
                if sp == 0:
                    break
                sp -= 1
                if kept > 0:
                    cur_base, cur_mask, cur_occ = st[sp % stackw]
                    kept -= 1
                else:
                    cur_base = cur_mask = cur_occ = 0
                if cur_mask == 0:
                    continue
            slot = ((cur_mask & -cur_mask).bit_length() - 1) ^ mask5
            cur_mask &= cur_mask - 1
            child = cur_base + bin(cur_occ & ((1 << slot) - 1)).count("1")
            steps += 1
            assert steps <= rows and 0 <= child < rows
            row = table[child]
            if row[255] > 0.5:
                hit, bits, ids, t, b = _lane_leaf(
                    row, pre, tm if any_hit else t_best)
                if any_hit:
                    if bool(hit.any()):
                        found = True
                        break
                    continue
                got, win = _lex_min(hit, bits)
                if got:
                    t_best, best_tri, bb, found = t[win], int(ids[win]), \
                        b[win], True
                continue
            new_mask = _ballot(_lane_slab_pred(
                row, oi, inv_d, mask5, tm if any_hit else t_best))
            if new_mask == 0:
                continue
            if cur_mask != 0:
                st[sp % stackw] = (cur_base, cur_mask, cur_occ)
                sp += 1
                kept = min(kept + 1, stackw)
            cur_base = int(row[192])
            cur_mask = new_mask
            cur_occ = int(row[193]) | (int(row[194]) << 16)
        valid[i] = found
        if found and not any_hit:
            t_out[i], tri_out[i], b_out[i] = t_best, best_tri, bb
    if any_hit:
        return valid
    return dict(valid=valid, t=t_out, tri=tri_out, b=b_out)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["one", "few", "leaf", "mid", "big",
                                  "twins", "deep"])
def test_warp_model_matches_plain(name, any_hit):
    table, depth, tri = _scene(name)
    o, d, t_max = _rays(np.random.default_rng(len(name)), 96, tri)
    stackw = max(depth, 1)
    got = warp_traverse(table, o, d, t_max, any_hit, stackw)
    want = pbvhw.bvhw_intersect(table, o, d, t_max, any_hit, stackw)
    if any_hit:
        assert torch.equal(got, want)
        assert bool(want.any()) and not bool(want.all())
        return
    assert bool(want["valid"].any()) and not bool(want["valid"].all())
    for key in ("valid", "tri", "t", "b"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("stackw", [1, 2])
def test_warp_model_short_stack_drops_oldest(stackw, any_hit):
    """A stack shallower than the tree: the entry pushed longest ago is
    overwritten, and a pop past the kept entries finds an empty node, as in
    the plain version's shifting stack. Some hits are lost; none differs."""
    table, depth, tri = _scene("deep")
    assert depth == 3
    # through the dense cluster (around (1, 1, 1)) toward a triangle
    # beyond it: a ray that misses the cluster's triangles needs the
    # entries pushed on the way down
    rng = np.random.default_rng(stackw)
    aim = tri[rng.integers(0, 600, 128)].mean(axis=1)
    through = (1.0 + rng.uniform(-0.2, 0.2, (128, 3))).astype(np.float32)
    d = aim - through
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.as_tensor(through - 2.0 * d), torch.as_tensor(d)
    t_max = torch.full((128,), torch.inf)
    got = warp_traverse(table, o, d, t_max, any_hit, stackw)
    want = pbvhw.bvhw_intersect(table, o, d, t_max, any_hit, stackw)
    full = pbvhw.bvhw_intersect(table, o, d, t_max, any_hit, depth)
    if any_hit:
        assert torch.equal(got, want)
        return
    for key in ("valid", "tri", "t", "b"):
        assert torch.equal(got[key], want[key]), key
    # two pushes at most in a tree of depth 3: a stack of 1 drops entries
    # on these rays, a stack of 2 holds them all
    assert torch.equal(want["t"], full["t"]) == (stackw == 2)


@pytest.mark.parametrize("name", ["few", "mid", "big"])
def test_lane_ballot_is_the_permuted_hit_mask(name):
    """On every interior row, the ballot of lane l's test of slot
    l ^ mask5 is the mask the plain traversal builds bit by bit."""
    table, _, tri = _scene(name)
    interior = torch.nonzero(table[:, 255] < 0.5)[:, 0][:40]
    o, d, t_max = _rays(np.random.default_rng(3), 24, tri)
    t_max = torch.where(t_max > 0, t_max, 2.0)
    inv_d = torch.reciprocal(d)
    mask5 = ((d[:, 0] < 0).long() * 18 + (d[:, 1] < 0).long() * 9
             + (d[:, 2] < 0).long() * 4)
    bitvals = torch.ones(1, BW, dtype=torch.long) << (LANES[None]
                                                      ^ mask5[:, None])
    n = o.shape[0]
    oc96 = o[:, :, None].expand(n, 3, BW).reshape(n, 3 * BW)
    ic96 = inv_d[:, :, None].expand(n, 3, BW).reshape(n, 3 * BW)
    seen = set()
    for r in interior.tolist():
        row = table[r]
        want = pbvhw._hit_mask(pbvhw._slab32(row[None].expand(n, -1), oc96,
                                             ic96, t_max), bitvals)
        for i in range(n):
            got = _ballot(_lane_slab_pred(row, o[i], inv_d[i],
                                          int(mask5[i]), t_max[i]))
            assert got == int(want[i])
            seen.add(got != 0)
    assert seen == {False, True}


def _tie_leaf(cols):
    """A leaf row whose columns ``cols`` all hold one triangle facing +z at
    z = 1; the other columns hold triangles farther away or pad."""
    row = torch.zeros(pbvhw.WW)
    ids = torch.full((LEAFW,), -1.0)
    tri = torch.tensor([-1.0, -1.0, 1.0, 3.0, -1.0, 1.0, -1.0, 3.0, 1.0])
    for j in range(12):  # 12 real columns, 13 pad
        z = 1.0 if j in cols else 1.5 + 0.25 * j
        row[torch.arange(9) * LEAFW + j] = torch.where(
            torch.arange(9) % 3 == 2, torch.tensor(z), tri)
        ids[j] = 100 + j
    row[9 * LEAFW:10 * LEAFW] = ids
    row[255] = 1.0
    return row


@pytest.mark.parametrize("cols", [(3, 7), (0, 11), (5,), (2, 4, 9)])
def test_leaf_lexicographic_min_is_the_first_minimum(cols):
    """Exact ties: the same triangle in several columns. The smallest
    (t bits, lane) is the column torch.min's first minimum picks."""
    row = _tie_leaf(cols)
    o = torch.tensor([[0.1, 0.2, -1.0], [0.3, 0.1, -0.5]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.05, 0.02, 1.0]])
    d = d / d.norm(dim=-1, keepdim=True)
    for i in range(2):
        pre = {k: v[:, None] for k, v in
               watertight_cols_pre(o[i:i + 1], d[i:i + 1]).items()}
        bound = torch.tensor(torch.inf)
        hit, bits, ids, t, b = _lane_leaf(row, pre, bound)
        assert int(hit.sum()) == 12 and not bool(hit[LEAFW:].any())
        got, win = _lex_min(hit, bits)
        st = dict(tri=torch.zeros(1, dtype=torch.int32), b0=torch.zeros(1),
                  b1=torch.zeros(1), b2=torch.zeros(1),
                  found=torch.zeros(1, dtype=torch.bool))
        t_new = pbvhw._leaf_closest(pre, bound.reshape(1), row[None],
                                    torch.ones(1, dtype=torch.bool), st)
        assert got and win == min(cols)
        assert int(st["tri"]) == 100 + win == int(ids[win])
        assert torch.equal(t_new[0], t[win])
        assert len({int(bits[c]) for c in cols}) == 1  # an exact tie
        for k, key in enumerate(("b0", "b1", "b2")):
            assert torch.equal(st[key][0], b[win, k])
    # nothing within the bound: no winner, as the plain leaf reports
    hit, bits, *_ = _lane_leaf(row, pre, torch.tensor(0.25))
    assert _lex_min(hit, bits) == (False, -1)


def test_unsigned_bit_order_is_float_order_on_positive_t():
    """__reduce_min_sync compares t's bits as unsigned integers: on
    positive floats (a hit has t > 0) that is the float order, subnormals
    and inf included."""
    t = torch.tensor([1e-45, 1e-38, 1e-20, 0.5, 1.0, 1.0000001, 3e38,
                      torch.inf])
    bits = t.view(torch.int32).long() & 0xFFFFFFFF
    assert bool((bits[1:] > bits[:-1]).all())
    assert int(bits[-1]) == INF_BITS
