"""Kernels K1, K2 and the gather probes P1-P9 on the card against their
plain PyTorch versions.

Every kernel is called as the wrappers call it: through the CPython
trampolines of ``csrc/pylaunch.c``. These tests need a CUDA card (marked
``cuda``; without one they skip: the kernel has no CPU or interpret mode).
The file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.accel.bvhw import build_bvhw
from pathtracer_tpu_torch.accel.bvhw import bvhw_intersect as bvhw_plain
from pathtracer_tpu_torch.ops.cuda import bvhw_cu as k2
from pathtracer_tpu_torch.ops.cuda import intersect_cu as k1
from pathtracer_tpu_torch.probes import gather as pg
from pathtracer_tpu_torch.probes import gather2 as pg2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _soup(seed, f, n, dev):
    """Random triangle soup and rays; a quarter of the rays get a finite
    t_max so the range test clips some hits."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (f, 3))
    p = [base, base + rng.normal(0, 0.5, (f, 3)),
         base + rng.normal(0, 0.5, (f, 3)), np.zeros((f, 3))]
    o = rng.uniform(-3, 3, (n, 3))
    d = rng.normal(size=(n, 3))
    t_max = np.where(rng.uniform(size=n) < 0.25, rng.uniform(0.5, 4.0, n),
                     np.inf)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(o), t(d), t(t_max), t(np.concatenate(p, axis=1))


@pytest.mark.cuda
@pytest.mark.parametrize("f,n", [(36, 131072), (300, 5000), (1, 129),
                                 (513, 1000)])
def test_kernel_matches_plain(dev, f, n):
    """Closest and any-hit, across one and several 256-row tiles and a
    ragged last block: flags and ids identical, t and b bit-identical."""
    o, d, t_max, tri_pack = _soup(f + n, f, n, dev)
    before = k1.LAUNCHES
    got = k1.intersect(o, d, t_max, tri_pack)
    got_any = k1.intersect(o, d, t_max, tri_pack, any_hit=True)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 2
    want = k1.intersect_plain(o, d, t_max, tri_pack)
    want_any = k1.intersect_plain(o, d, t_max, tri_pack, any_hit=True)
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["tri"], want["tri"])
    assert torch.equal(got_any, want_any)
    assert torch.equal(got["t"], want["t"])
    assert torch.equal(got["b"], want["b"])


@pytest.mark.cuda
def test_kernel_handles_empty_and_rejects_strided(dev):
    o, d, t_max, tri_pack = _soup(0, 8, 16, dev)
    before = k1.LAUNCHES
    empty = k1.intersect(o[:0], d[:0], t_max[:0], tri_pack)
    assert empty["valid"].shape == (0,) and k1.LAUNCHES == before
    with pytest.raises(ValueError, match="contiguous"):
        k1.intersect(o, d, t_max, tri_pack.t().contiguous().t())
    with pytest.raises(ValueError, match="on"):
        k1.intersect(o, d, t_max, tri_pack.cpu())
    assert k1.LAUNCHES == before


def _assert_k1_equals_plain(o, d, t_max, tri_pack):
    """K1's closest and any hit against its plain version: every output
    ``torch.equal``, one launch a query. Returns the plain results."""
    before = k1.LAUNCHES
    got = k1.intersect(o, d, t_max, tri_pack)
    got_any = k1.intersect(o, d, t_max, tri_pack, any_hit=True)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + (2 if o.shape[0] else 0)
    want = k1.intersect_plain(o, d, t_max, tri_pack)
    want_any = k1.intersect_plain(o, d, t_max, tri_pack, any_hit=True)
    for key in ("valid", "tri", "t", "b"):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(got_any, want_any)
    return want, want_any


def _k1_case(case, dev, f=70, n=4099):
    """Rays and triangles that take K1's redesign apart: ties (every
    triangle twice, so equal t at two indices), mixed kz in every warp
    (axis-parallel rays and |dx| == |dy|, |dy| == |dz| ties of the kz
    rule), dead lanes (t_max 0, -0, -1, -inf, NaN) beside live ones, and
    an input whose lanes are all dead."""
    o, d, t_max, tri_pack = _soup(f + n, f, n, dev)
    if case == "ties":
        tri_pack = torch.cat([tri_pack, tri_pack])
    elif case == "mixed_kz":
        axes = torch.tensor([[1, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0],
                             [1, 1, 0.5], [0.5, -1, 1], [-1, 0.25, -1],
                             [1, -1, 1]], dtype=torch.float32, device=dev)
        d = d.clone()
        d[::3] = axes.repeat(n // 3 // 8 + 1, 1)[:d[::3].shape[0]]
    elif case == "dead_lanes":
        dead = torch.tensor([0.0, -0.0, -1.0, -torch.inf, torch.nan],
                            device=dev)
        t_max = t_max.clone()
        t_max[1::2] = dead.repeat(n // 10 + 1)[:t_max[1::2].shape[0]]
    elif case == "all_dead":
        t_max = torch.where(torch.arange(n, device=dev) % 2 == 0, 0.0,
                            torch.nan)
    return o, d, t_max.contiguous(), tri_pack.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "mixed_kz", "dead_lanes",
                                  "all_dead"])
def test_kernel_redesign_cases(dev, case):
    want, want_any = _assert_k1_equals_plain(*_k1_case(case, dev))
    if case == "all_dead":
        assert not want["valid"].any() and not want_any.any()
    else:
        assert want["valid"].any() and not want["valid"].all()
    if case == "ties":  # the first of each pair of copies wins
        assert bool((want["tri"][want["valid"]] < 70).all())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 128, 256, 257, 513])
def test_kernel_triangle_counts(dev, f):
    """One tile, a full tile, one triangle into the next, three tiles;
    a ragged last block; dead lanes throughout."""
    o, d, t_max, tri_pack = _k1_case("dead_lanes", dev, f=f, n=2053)
    _assert_k1_equals_plain(o, d, t_max, tri_pack)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 4099])
def test_kernel_ragged_ray_counts(dev, n):
    _assert_k1_equals_plain(*_k1_case("dead_lanes", dev, f=36, n=n))


def _bvh_case(seed, f, n, dev):
    """Random soup, its BVH32 table and depth, and rays from inside and
    around it; a quarter of the rays get a finite t_max, some are dead
    (t_max = 0) and some axis-parallel (1/d = inf)."""
    rng = np.random.default_rng(seed)
    c = (rng.random((f, 1, 3)) * 2 - 1) * 4.0
    tri = (c + (rng.random((f, 3, 3)) * 2 - 1) * 0.4).astype(np.float32)
    table, order, depth = build_bvhw(tri[:, 0], tri[:, 1], tri[:, 2])
    tri = tri[order]
    o = ((rng.random((n, 3)) * 2 - 1) * 6).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::17, 1:] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.25, rng.uniform(0.5, 6.0, n),
                     np.inf).astype(np.float32)
    t_max[::13] = 0.0
    pack = np.concatenate([tri.reshape(f, 9), np.zeros((f, 3))], axis=1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(table), depth, t(o), t(d), t(t_max), t(pack)


@pytest.mark.cuda
@pytest.mark.parametrize("f,n", [(5, 1000), (26, 4096), (3000, 65536),
                                 (20000, 8192)])
def test_bvhw_kernel_matches_plain_and_k1(dev, f, n):
    """K2 against its plain version (valid, tri, any-hit, t and b
    identical) and against brute force K1 (valid identical, t to rtol
    1e-5; tri only where t ties)."""
    table, depth, o, d, t_max, pack = _bvh_case(f + n, f, n, dev)
    before = k2.LAUNCHES
    got = k2.bvhw_intersect(table, o, d, t_max, stackw=depth)
    got_any = k2.bvhw_intersect(table, o, d, t_max, any_hit=True,
                                stackw=depth)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 2
    want = bvhw_plain(table, o, d, t_max, stackw=depth)
    want_any = bvhw_plain(table, o, d, t_max, any_hit=True, stackw=depth)
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["tri"], want["tri"])
    assert torch.equal(got_any, want_any)
    assert torch.equal(got["t"], want["t"])
    assert torch.equal(got["b"], want["b"])
    brute = k1.intersect(o, d, t_max, pack)
    assert torch.equal(got["valid"], brute["valid"])
    v = brute["valid"]
    torch.testing.assert_close(got["t"][v], brute["t"][v], rtol=1e-5,
                               atol=0.0)
    differ = v & (got["tri"] != brute["tri"])
    assert torch.equal(got["t"][differ], brute["t"][differ])
    assert torch.equal(got_any, k1.intersect(o, d, t_max, pack,
                                             any_hit=True))


@pytest.mark.cuda
def test_bvhw_kernel_short_stack_and_rejects(dev):
    table, depth, o, d, t_max, _ = _bvh_case(3, 3000, 4096, dev)
    for stackw in (1, 10):
        got = k2.bvhw_intersect(table, o, d, t_max, stackw=stackw)
        want = bvhw_plain(table, o, d, t_max, stackw=stackw)
        assert torch.equal(got["valid"], want["valid"])
        assert torch.equal(got["tri"], want["tri"])
    before = k2.LAUNCHES
    with pytest.raises(ValueError, match="stackw"):
        k2.bvhw_intersect(table, o, d, t_max, stackw=11)
    with pytest.raises(ValueError, match="contiguous"):
        k2.bvhw_intersect(table.t().contiguous().t(), o, d, t_max)
    with pytest.raises(TypeError, match="float32"):
        k2.bvhw_intersect(table.double(), o, d, t_max)
    assert k2.LAUNCHES == before


def _assert_k2_equals_plain(table, o, d, t_max, stackw):
    """Closest and any hit, bit for bit; one launch each unless N = 0."""
    before = k2.LAUNCHES
    got = k2.bvhw_intersect(table, o, d, t_max, stackw=stackw)
    got_any = k2.bvhw_intersect(table, o, d, t_max, any_hit=True,
                                stackw=stackw)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + (2 if o.shape[0] else 0)
    want = bvhw_plain(table, o, d, t_max, stackw=stackw)
    for key in ("valid", "tri", "t", "b"):
        assert got[key].shape == want[key].shape
        assert got[key].dtype == want[key].dtype
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(got_any, bvhw_plain(table, o, d, t_max, any_hit=True,
                                           stackw=stackw))
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 7, 31, 33, 1000, 4099])
def test_bvhw_kernel_ragged_ray_counts(dev, n):
    """N = 0 and 1, and N that fills neither a warp's rays, a warp's 32
    lanes nor a block."""
    table, depth, o, d, t_max, _ = _bvh_case(n, 3000, max(n, 1), dev)
    want = _assert_k2_equals_plain(table, o[:n], d[:n], t_max[:n], depth)
    if n >= 1000:
        assert want["valid"].any() and not want["valid"].all()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [5, 3000])
def test_bvhw_kernel_all_lanes_dead(dev, f):
    """t_max = 0, negative or NaN on every lane: no hit, zeros out."""
    table, depth, o, d, t_max, _ = _bvh_case(f, f, 777, dev)
    t_max = torch.zeros_like(t_max)
    t_max[1::3] = -1.0
    t_max[2::3] = float("nan")
    want = _assert_k2_equals_plain(table, o, d, t_max, depth)
    assert not want["valid"].any() and not want["t"].any()


@pytest.mark.cuda
def test_bvhw_kernel_two_row_table(dev):
    """A soup that fits one leaf: a root row with one child."""
    table, depth, o, d, t_max, _ = _bvh_case(9, 5, 2000, dev)
    assert table.shape[0] == 2 and depth == 1
    # aim every other ray at the soup's centre
    centre = table[1, :9 * 25].reshape(3, 3, 25)[:, :, :5].mean(dim=(0, 2))
    d[::2] = torch.nn.functional.normalize(centre - o[::2], dim=-1)
    want = _assert_k2_equals_plain(table, o, d, t_max, depth)
    assert want["valid"].any() and not want["valid"].all()


def _deep_case(dev, n=4096):
    """A table of depth 3 (a dense cluster of small triangles inside a
    sparse soup) and rays through the cluster toward the soup beyond it."""
    rng = np.random.default_rng(600)

    def soup(f, spread, size):
        c = (rng.random((f, 1, 3)) * 2 - 1) * spread
        return (c + (rng.random((f, 3, 3)) * 2 - 1) * size).astype(np.float32)
    tri = np.concatenate([soup(600, 4.0, 0.4),
                          soup(800, 0.3, 0.02) + np.float32(1)])
    table, _, depth = build_bvhw(tri[:, 0], tri[:, 1], tri[:, 2])
    aim = tri[rng.integers(0, 600, n)].mean(axis=1)
    through = (1.0 + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    d = aim - through
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(table), depth, t(through - 2.0 * d), t(d)


@pytest.mark.cuda
@pytest.mark.parametrize("stackw", [1, 2, 3, 10])
def test_bvhw_kernel_stack_shallower_than_the_tree(dev, stackw):
    """A stack of 1 under a tree of depth 3 drops its oldest entry, and
    the kernel loses the hits the plain version loses."""
    table, depth, o, d = _deep_case(dev)
    assert depth == 3
    t_inf = torch.full((o.shape[0],), torch.inf, device=dev)
    want = _assert_k2_equals_plain(table, o, d, t_inf, stackw)
    full = bvhw_plain(table, o, d, t_inf, stackw=depth)
    assert torch.equal(want["t"], full["t"]) == (stackw >= 2)


@pytest.mark.cuda
def test_bvhw_kernel_bounce_rays(dev):
    """The rays of a later bounce: origins just off the closest hits of a
    first set, random directions, the first set's misses dead."""
    table, depth, o, d, t_max, _ = _bvh_case(5, 3000, 20000, dev)
    first = _assert_k2_equals_plain(table, o, d, t_max, depth)
    live = first["valid"]
    assert live.any() and not live.all()
    rng = np.random.default_rng(1)
    d2 = rng.normal(size=(o.shape[0], 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o2 = (o + d * first["t"][:, None] - 1e-3 * d).contiguous()
    t2 = torch.where(live, torch.inf, torch.zeros((), device=dev))
    second = _assert_k2_equals_plain(table, o2,
                                     torch.as_tensor(d2, device=dev), t2,
                                     depth)
    assert second["valid"].any() and not second["valid"][~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pid", ["P1", "P2", "P3", "P4", "P5"])
def test_gather_probe_matches_plain(dev, pid):
    x = pg.probe_inputs(dev)
    got = pg.PROBES[pid](x)
    torch.cuda.synchronize()
    assert torch.equal(got, pg.PLAIN[pid](x))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 3, 8, 13])
@pytest.mark.parametrize("n", [0, 1, 33, 257, 8193])
def test_gather_cols_ragged_shapes(dev, n, w):
    """P3 at ragged lane counts and table widths: equal to its plain
    version, one launch a call, none for zero lanes."""
    rng = np.random.default_rng(n * 100 + w)
    m = 1000
    table_t = torch.as_tensor(rng.random((w, m), np.float32), device=dev)
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[:1], idx[-1:] = 0, m - 1
    idx = torch.as_tensor(idx, device=dev)
    before = dict(pg.LAUNCHES)
    got = pg.gather_cols(table_t, idx)
    torch.cuda.synchronize()
    assert pg.LAUNCHES == dict(before, gather_cols=before["gather_cols"]
                               + int(n > 0))
    assert got.shape == (w, n) and got.is_contiguous()
    assert torch.equal(got, pg.gather_cols_plain(table_t, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 33, 64])
@pytest.mark.parametrize("n", [0, 1, 63, 65, 8193])
def test_stack_push_read_ragged_shapes(dev, n, depth):
    """P5 at ragged lane counts and depths, pointers at 0, at depth - 1
    and between: equal to its plain version, one launch a call, none for
    zero lanes."""
    rng = np.random.default_rng(n * 100 + depth)
    sp = rng.integers(0, depth, n).astype(np.int32)
    sp[:1], sp[-1:] = 0, depth - 1
    sp = torch.as_tensor(sp, device=dev)
    v = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    before = dict(pg.LAUNCHES)
    got = pg.stack_push_read(sp, v, depth)
    torch.cuda.synchronize()
    assert pg.LAUNCHES == dict(
        before, stack_push_read=before["stack_push_read"] + int(n > 0))
    assert torch.equal(got, pg.stack_push_read_plain(sp, v, depth))
    assert torch.equal(got, v)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w", [1, 3, 4, 8, 13, 40])
@pytest.mark.parametrize("n", [0, 1, 33, 257, 8193])
@pytest.mark.parametrize("kernel", ["gather_rows", "gather_rows_warp"])
def test_row_gathers_ragged_shapes(dev, kernel, n, w, offset):
    """P1 / P2 (``gather_rows``) and P4 (``gather_rows_warp``) at ragged
    lane counts and widths (a ragged last warp run; W = 8's unrolled
    paths, the other widths' loops, W > 32), indices at the first and last
    rows, on a table that starts at its allocation and one float past it
    (not 16-byte aligned: P1 then moves words, not float4): equal to the
    plain version, one launch a call, none for zero lanes."""
    rng = np.random.default_rng(n * 100 + w)
    m = 1000
    flat = torch.zeros(m * w + offset, device=dev)
    table = flat[offset:].view(m, w)
    table.copy_(torch.as_tensor(rng.random((m, w), np.float32)))
    assert (table.data_ptr() % 16 != 0) == offset
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[:1], idx[-1:] = 0, m - 1
    idx = torch.as_tensor(idx, device=dev)
    before = dict(pg.LAUNCHES)
    got = getattr(pg, kernel)(table, idx)
    torch.cuda.synchronize()
    assert pg.LAUNCHES == dict(before, **{kernel: before[kernel]
                                          + int(n > 0)})
    assert got.shape == (n, w) and got.is_contiguous()
    assert torch.equal(got, pg.gather_rows_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("pid", ["P6", "P7", "P8", "P9"])
def test_gather_probe2_matches_plain(dev, pid):
    """Bit for bit: the probes move words (P9 adds exact zeros)."""
    x = pg2.probe_inputs(dev)
    before = sum(pg2.LAUNCHES.values())
    got = pg2.PROBES[pid](x)
    torch.cuda.synchronize()
    assert sum(pg2.LAUNCHES.values()) == before + 1
    assert torch.equal(got, pg2.PLAIN[pid](x))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 1, 3, 65, 0])
def test_gather_sublane_and_lane_ragged_rows(dev, rows):
    """P6, P7 and P8 through the launch path at the probe's and at ragged
    row counts (P8's indices at a chunk's first and last lane among
    them): equal to their plain versions, one launch a call (none for
    zero rows)."""
    x = pg2.ragged_inputs(rows, dev)
    before = dict(pg2.LAUNCHES)
    got = {pid: pg2.PROBES[pid](x) for pid in ("P6", "P7", "P8")}
    torch.cuda.synchronize()
    launched = int(rows > 0)
    assert pg2.LAUNCHES == dict(before, **{
        k: before[k] + launched
        for k in ("gather_sublane", "gather_lane", "gather_two_step")})
    for pid, out in got.items():
        assert out.shape == (rows, 128) and out.is_contiguous()
        assert torch.equal(out, pg2.PLAIN[pid](x)), pid


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("rows", [64, 1, 3, 65])
def test_gather_two_step_misaligned_idx(dev, rows, offset):
    """P8 on an idx that is a contiguous view 1-3 words into its
    allocation (not 16-byte aligned; the kernel moves words, so it takes
    any alignment): equal to the plain version, one launch a call."""
    x = pg2.ragged_inputs(rows, dev, offset)
    assert x["idx_i"].data_ptr() % 16 == 4 * offset
    before = pg2.LAUNCHES["gather_two_step"]
    got = pg2.gather_two_step(x["flat2"], x["idx_i"])
    torch.cuda.synchronize()
    assert pg2.LAUNCHES["gather_two_step"] == before + 1
    assert torch.equal(got, pg2.gather_two_step_plain(x["flat2"],
                                                      x["idx_i"]))


# an index out of [0, 128 C) stops P8's kernel: the trap poisons the CUDA
# context, so it runs in a process of its own
_P8_TRAP = """
import sys
import torch
from pathtracer_tpu_torch.probes import gather2 as pg2
bad, offset = int(sys.argv[1]), int(sys.argv[2])
x = pg2.ragged_inputs(3, torch.device("cuda"), offset)
x["idx_i"][1, 77] = bad
pg2.gather_two_step(x["flat2"], x["idx_i"])
try:
    torch.cuda.synchronize()
except RuntimeError as err:
    print("trapped:", err)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("bad,offset", [(-1, 0), (128 * pg2.C, 1)])
def test_gather_two_step_traps_out_of_range(dev, bad, offset):
    """An index below 0 (idx 16-byte aligned) or at 128 C (idx off 16
    bytes) stops the kernel with a trap, which the next synchronisation
    raises."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _P8_TRAP, str(bad),
                          str(offset)], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert "trapped:" in res.stdout, res.stdout + res.stderr


@pytest.mark.cuda
def test_gather_probe2_other_shapes_and_rejects(dev):
    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(a, device=dev)
    data = t(rng.random((7, 128), np.float32))
    idx = t(rng.integers(0, 7, (5, 128)).astype(np.int32))
    assert torch.equal(pg2.gather_sublane(data, idx),
                       pg2.gather_sublane_plain(data, idx))
    idx2 = t(rng.integers(0, 7 * 128, (3, 128)).astype(np.int32))
    assert torch.equal(pg2.gather_two_step(data, idx2),
                       pg2.gather_two_step_plain(data, idx2))
    tbl = t(rng.normal(size=(128, 128)).astype(np.float32))
    idx3 = t(rng.integers(0, 128, (1, 128)).astype(np.int32))
    out = torch.full((1, 128, 128), float("nan"), device=dev)
    assert pg2.onehot_matmul(tbl, idx3, out=out) is out
    assert torch.equal(out, pg2.onehot_matmul_plain(tbl, idx3))
    before = dict(pg2.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        pg2.gather_lane(data[:5].t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="out"):
        pg2.onehot_matmul(tbl, idx3, out=out[:, :64])
    with pytest.raises(ValueError, match="on"):
        pg2.gather_sublane(data.cpu(), idx)
    assert pg2.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 1, 3, 65])
def test_onehot_matmul_special_values(dev, rows):
    """P9 on the special-values table (-0, +inf, -inf, NaN, all-negative
    columns) at the probe's and at ragged row counts, against its plain
    version (the one-hot product): NaN in the same places, equal values
    and sign bits elsewhere; one launch a call."""
    sv = pg2.special_inputs(rows, dev)
    before = pg2.LAUNCHES["onehot_matmul"]
    got = pg2.onehot_matmul(sv["tbl"], sv["idx"])
    torch.cuda.synchronize()
    assert pg2.LAUNCHES["onehot_matmul"] == before + 1
    assert pg2.equal_off_nan(got, pg2.onehot_matmul_plain(sv["tbl"],
                                                          sv["idx"]))


@pytest.mark.cuda
def test_onehot_matmul_out_reuse(dev):
    """``out=`` is written in place, each call with its own indices; an
    out that is not 16-byte aligned raises before any launch."""
    rng = np.random.default_rng(11)
    tbl = torch.as_tensor(rng.normal(size=(128, 128)).astype(np.float32),
                          device=dev)
    idx_a, idx_b = (torch.as_tensor(rng.integers(0, 128, (2, 128))
                                    .astype(np.int32), device=dev)
                    for _ in range(2))
    out = torch.full((2, 128, 128), float("nan"), device=dev)
    for idx in (idx_a, idx_b, idx_a):
        assert pg2.onehot_matmul(tbl, idx, out=out) is out
        assert torch.equal(out, pg2.onehot_matmul_plain(tbl, idx))
    before = pg2.LAUNCHES["onehot_matmul"]
    shifted = torch.empty(2 * 128 * 128 + 1, device=dev)[1:].view(out.shape)
    with pytest.raises(ValueError, match="aligned"):
        pg2.onehot_matmul(tbl, idx_a, out=shifted)
    assert pg2.LAUNCHES["onehot_matmul"] == before


@pytest.mark.cuda
def test_onehot_matmul_one_inf_at_a_selected_row(dev):
    """An inf at one row of one column: the rows that select it read inf
    there and every other row NaN (0 * inf); other columns are copies."""
    rng = np.random.default_rng(12)
    tbl = rng.normal(size=(128, 128)).astype(np.float32)
    tbl[5, 9] = np.inf
    idx = rng.integers(0, 128, (3, 128)).astype(np.int32)
    idx[:, ::16] = 5
    tbl, idx = torch.as_tensor(tbl, device=dev), torch.as_tensor(idx,
                                                                 device=dev)
    got = pg2.onehot_matmul(tbl, idx)
    assert pg2.equal_off_nan(got, pg2.onehot_matmul_plain(tbl, idx))
    rows, sel = got.reshape(-1, 128), idx.reshape(-1) == 5
    assert rows[sel, 9].isposinf().all() and rows[~sel, 9].isnan().all()
    keep = torch.ones(128, dtype=torch.bool, device=dev)
    keep[9] = False
    assert torch.equal(rows[:, keep], tbl[idx.reshape(-1).long()][:, keep])


CLASSROOM = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "classroom_proc.glb")


@pytest.mark.cuda
def test_load_gltf_places_every_leaf_on_the_card(dev):
    import dataclasses

    from pathtracer_tpu_torch.integrator import TracedScene
    from pathtracer_tpu_torch.scene.gltf import load_gltf
    _, sd, _ = load_gltf(CLASSROOM, resolution=(64, 36), device=dev)
    _, ref, _ = load_gltf(CLASSROOM, resolution=(64, 36), device="cpu")
    for f in dataclasses.fields(sd):
        leaf = getattr(sd, f.name)
        for name, x in ((f.name, leaf),) if f.name != "tex" else \
                ((g.name, getattr(leaf, g.name))
                 for g in dataclasses.fields(leaf)):
            assert x.is_cuda, name
            ref_x = getattr(ref.tex if f.name == "tex" else ref, name)
            assert torch.equal(x.cpu(), ref_x), name
    ts = TracedScene.create(sd)
    assert ts.bw_rows.is_cuda and ts.data.tex.data.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("mis_mode", ["ref", "onesample"])
def test_classroom_card_film_matches_cpu_film(dev, mis_mode):
    """Classroom at 64x36, 2 spp, depth 5: the card (K2 on every query,
    none of K1) against the CPU's plain traversal, at RMSE < 1e-3 and
    alpha rtol 1e-5."""
    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.scene.gltf import load_gltf
    films = {}
    for where in ("cpu", dev):
        cam, sd, _ = load_gltf(CLASSROOM, resolution=(64, 36), device=where)
        k1_before, k2_before = k1.LAUNCHES, k2.LAUNCHES
        films[str(where)] = PathIntegrator(
            PathConfig(max_depth=5, mis_mode=mis_mode), spp=2).render(
                cam, sd).cpu().numpy()
        if where != "cpu":
            assert k1.LAUNCHES == k1_before and k2.LAUNCHES > k2_before
    got, want = films[str(dev)], films["cpu"]
    assert np.isfinite(got).all() and (got[..., 3] > 0).all()
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    assert np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2)) < 1e-3


SPONZA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "sponza_proc.glb")


@pytest.mark.cuda
@pytest.mark.parametrize("mis_mode", ["ref", "onesample"])
def test_sponza_card_film_matches_cpu_film(dev, mis_mode):
    """Sponza at 48x27, 2 spp, depth 1 (the golden's configuration): the
    card (K2 on the main table and on the alpha subset's, with re-spawn
    retries) against the CPU's plain traversals, at RMSE < 1e-3 and alpha
    rtol 1e-5."""
    from pathtracer_tpu_torch import integrator as pint
    from pathtracer_tpu_torch.scene.gltf import load_gltf
    films = {}
    for where in ("cpu", dev):
        cam, sd, _ = load_gltf(SPONZA, resolution=(48, 27), device=where)
        k2_before = k2.LAUNCHES
        alpha_before = pint.RETRY_COUNTS["alpha_tree"]
        films[str(where)] = pint.PathIntegrator(
            pint.PathConfig(max_depth=1, mis_mode=mis_mode), spp=2).render(
                cam, sd).cpu().numpy()
        if where != "cpu":  # K2 on both tables
            alpha = pint.RETRY_COUNTS["alpha_tree"] - alpha_before
            assert k2.LAUNCHES - k2_before > alpha > 0
    got, want = films[str(dev)], films["cpu"]
    assert np.isfinite(got).all() and (got[..., 3] > 0).all()
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5)
    assert np.sqrt(np.mean((got[..., :3] - want[..., :3]) ** 2)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["brute", "dense", "tree", "binary"])
def test_alpha_route_card_matches_cpu(dev, route):
    """Each alpha route on the card against the same route on the CPU,
    on rays through the masks: the brute-force route (K1 and re-spawn
    retries), the dense pass, the subset's table (K2 and re-spawn
    retries), the binary tree of an all-masked scene. Hits and occlusion
    equal; t within rtol 1e-4 and b within 1e-4 (a re-spawned lane's
    origin carries the rounding of its first hit, which PyTorch's CUDA
    ops may round otherwise than its CPU ops)."""
    from pathtracer_tpu_torch.integrator import (TracedScene,
                                                 _scene_intersect,
                                                 _scene_intersect_p)
    from pathtracer_tpu_torch.scene.scene import SceneBuilder
    from torch_alpha_scenes import ROUTES, build, rays
    fill, use_bvh, _ = ROUTES[route]
    o, d, o2, d2, t2 = rays(len(route), n=4096)
    out = {}
    for where in ("cpu", dev):
        ts = TracedScene.create(build(SceneBuilder, fill, device=where),
                                use_bvh=use_bvh)

        def t(a):
            return torch.as_tensor(a, device=where)
        hit = _scene_intersect(ts, t(o), t(d), torch.inf)
        occ = _scene_intersect_p(ts, t(o2), t(d2), t(t2))
        out[str(where)] = ({k: v.cpu() for k, v in hit.items()}, occ.cpu())
    (got, occ), (want, occ_want) = out[str(dev)], out["cpu"]
    assert torch.equal(occ, occ_want)
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["tri"], want["tri"])
    valid = want["valid"]
    assert valid.any() and occ_want.any() and not occ_want.all()
    for key, tol in (("t", 1e-4), ("b", 1e-4)):
        np.testing.assert_allclose(got[key][valid].numpy(),
                                   want[key][valid].numpy(), rtol=tol,
                                   atol=1e-4 if key == "b" else 1e-6)
