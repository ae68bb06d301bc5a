"""The port's BVH route against the JAX package: the binary SAH build, the
BVH32 collapse, the all-columns watertight test, and the plain version of
kernel K2 (``accel/bvhw.bvhw_intersect``).

Builds must be equal field for field and tables bit for bit. The plain
traversal must give brute force's hits (valid and tri exact, t to rtol
1e-5 / atol 1e-6, as tests/test_bvhw.py holds the JAX traversal) and the
JAX traversal's on one identical table: valid and tri exact, t to rtol
1e-6 / atol 1e-7. Barycentrics are held to JAX's at rtol 1e-5 / atol 1e-6:
the JAX traversal is compiled (a while_loop), and XLA's CPU fusion rounds
near-edge edge functions differently from the JAX package's own op-by-op
watertight test, which the port matches bit for bit (checked below through
the port's brute force on the same lanes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel.bvh import build_bvh as jbuild_bvh
from pathtracer_tpu.accel.bvhw import build_bvhw as jbuild_bvhw
from pathtracer_tpu.accel.bvhw import bvhw_intersect as jbvhw_intersect
from pathtracer_tpu.integrator import TracedScene as JTracedScene
from pathtracer_tpu.ops.intersect import watertight_cols_pre as jcols_pre
from pathtracer_tpu.ops.intersect import watertight_hit_cols as jhit_cols
from pathtracer_tpu.ops.intersect import watertight_hit_diag as jhit_diag
from pathtracer_tpu.scene.procedural import box_field_scene as jbox_field
from pathtracer_tpu.scene.scene import reorder_triangles as jreorder
from pathtracer_tpu_torch.accel import bvh as pbvh
from pathtracer_tpu_torch.accel import bvhw as pbvhw
from pathtracer_tpu_torch.integrator import TracedScene
from pathtracer_tpu_torch.interop import (scene_from_reference,
                                          traced_scene_from_reference)
from pathtracer_tpu_torch.ops import intersect as pi
from pathtracer_tpu_torch.ops.cuda import bvhw_cu
from pathtracer_tpu_torch.scene.scene import reorder_triangles
from torch_leaves import assert_scene_equal

torch.set_num_threads(1)

SIZES = [1, 5, 26, 600, 3000]


def _soup(rng, f, spread=4.0, size=0.4):
    c = (rng.random((f, 1, 3)) * 2 - 1) * spread
    tri = (c + (rng.random((f, 3, 3)) * 2 - 1) * size).astype(np.float32)
    return tri[:, 0], tri[:, 1], tri[:, 2]


def _rays(rng, n, spread=6.0):
    o = ((rng.random((n, 3)) * 2 - 1) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _case(f, n=512):
    """Soup of f triangles, its port table (reordered soup) and rays."""
    rng = np.random.default_rng(f)
    p = _soup(rng, f)
    table, order, depth = pbvhw.build_bvhw(*p)
    o, d = _rays(rng, n)
    return [x[order] for x in p], table, depth, o, d


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("f,native",
                         [(f, False) for f in SIZES] + [(3000, True)])
def test_build_bvh_matches_jax(f, native):
    p = _soup(np.random.default_rng(f), f)
    got = pbvh.build_bvh(*p, native=native)
    want = jbuild_bvh(*p, native=native)
    assert got.max_leaf == want.max_leaf
    for name in ("bounds_min", "bounds_max", "offset", "n_prims", "axis",
                 "order"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("f", SIZES)
def test_build_bvhw_bit_equal(f):
    p = _soup(np.random.default_rng(f), f)
    table, order, depth = pbvhw.build_bvhw(*p)
    jtable, jorder, jdepth = jbuild_bvhw(*p)
    assert table.dtype == np.float32 and depth == jdepth
    np.testing.assert_array_equal(order, jorder)
    assert table.tobytes() == np.asarray(jtable).tobytes()


def test_watertight_cols_match_jax():
    """The all-columns form against JAX's on (N, 25) triangle columns, and
    against the port's own diagonal form lane by lane."""
    rng = np.random.default_rng(5)
    n = 256
    o, d = _rays(rng, n, spread=2.0)
    c9 = rng.uniform(-2, 2, (9, n, 25)).astype(np.float32)
    t_max = np.where(rng.random(n) < 0.3, 1.5, np.inf).astype(np.float32)
    pre = {k: v[:, None] for k, v in pi.watertight_cols_pre(
        _t(o), _t(d)).items()}
    jpre = {k: v[:, None] for k, v in jcols_pre(
        jnp.asarray(o), jnp.asarray(d)).items()}
    got = pi.watertight_hit_cols(pre, _t(t_max)[:, None],
                                 [_t(c) for c in c9])
    want = jhit_cols(jpre, jnp.asarray(t_max)[:, None],
                     [jnp.asarray(c) for c in c9])
    hit = np.asarray(want[4])
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got[4].numpy(), hit)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit],
                                   rtol=1e-6, atol=1e-7)
    # column 0 against the diagonal form: identical bits
    tris = [_t(c9[3 * v:3 * v + 3, :, 0].T.copy()) for v in range(3)]
    t, b, h = pi.watertight_hit_diag(_t(o), _t(d), _t(t_max), *tris)
    assert torch.equal(h, got[4][:, 0])
    assert torch.equal(t[h], got[0][:, 0][h])
    for k in range(3):
        assert torch.equal(b[:, k][h], got[1 + k][:, 0][h])
    jt, _, jh = jhit_diag(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                          *[jnp.asarray(x.numpy()) for x in tris])
    np.testing.assert_array_equal(np.asarray(jh), h.numpy())


@pytest.mark.parametrize("f", SIZES)
def test_plain_bvhw_matches_brute(f):
    """Closest hit with t_max = inf, and any-hit with finite t_max."""
    p, table, depth, o, d = _case(f)
    n = len(o)
    table_t, o_t, d_t = _t(table), _t(o), _t(d)
    t_inf = torch.full((n,), torch.inf)
    got = pbvhw.bvhw_intersect(table_t, o_t, d_t, t_inf,
                               stackw=max(depth, 1))
    want = pi.intersect_brute(o_t, d_t, t_inf, *[_t(x) for x in p])
    v = want["valid"]
    assert torch.equal(got["valid"], v)
    assert torch.equal(got["tri"][v], want["tri"][v])
    torch.testing.assert_close(got["t"][v], want["t"][v], rtol=1e-5,
                               atol=1e-6)
    # same watertight arithmetic as brute force: same bits on hit lanes
    assert torch.equal(got["t"][v], want["t"][v])
    assert torch.equal(got["b"][v], want["b"][v])
    assert bool((got["t"][~v] == 0).all() and (got["b"][~v] == 0).all())

    t_b = torch.where(v, want["t"] * 1.5, 0.5)
    occ = pbvhw.bvhw_intersect(table_t, o_t, d_t, t_b, any_hit=True,
                               stackw=max(depth, 1))
    occ_want = pi.intersect_p_brute(o_t, d_t, t_b, *[_t(x) for x in p])
    assert torch.equal(occ, occ_want)


@pytest.mark.parametrize("f", SIZES)
def test_plain_bvhw_matches_jax_traversal(f):
    p, table, depth, o, d = _case(f)
    n = len(o)
    rng = np.random.default_rng(f + 1)
    t_max = np.where(rng.random(n) < 0.25, rng.uniform(0.5, 6.0, n),
                     np.inf).astype(np.float32)
    stackw = max(depth, 1)
    got = pbvhw.bvhw_intersect(_t(table), _t(o), _t(d), _t(t_max),
                               stackw=stackw)
    want = jbvhw_intersect(jnp.asarray(table), jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(t_max), stackw=stackw)
    for key in ("valid", "tri"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]),
                               rtol=1e-5, atol=1e-6)
    occ = pbvhw.bvhw_intersect(_t(table), _t(o), _t(d), _t(t_max),
                               any_hit=True, stackw=stackw)
    jocc = jbvhw_intersect(jnp.asarray(table), jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(t_max), any_hit=True,
                           stackw=stackw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


@pytest.mark.parametrize("stackw", [1, 2, 10])
def test_plain_bvhw_short_stack_matches_jax(stackw):
    """A stack shallower than the tree drops its oldest entries exactly
    as the reference's shifting stack does (misses, never wrong hits)."""
    p, table, depth, o, d = _case(3000)
    t_inf = np.full(len(o), np.inf, np.float32)
    got = pbvhw.bvhw_intersect(_t(table), _t(o), _t(d), _t(t_inf),
                               stackw=stackw)
    want = jbvhw_intersect(jnp.asarray(table), jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(t_inf), stackw=stackw)
    for key in ("valid", "tri"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("f", [26, 600])
def test_plain_bvhw_row_counts(f):
    """The work counts are per ray: the lockstep batch counts what the
    rays one at a time count. Slabs are the occupied children only, and
    triangles the real ids of the leaves visited, not their 25 columns."""
    p, table, depth, o, d = _case(f, n=48)
    table_t = _t(table)
    ids = table[:, 9 * pbvhw.LEAFW:10 * pbvhw.LEAFW]
    real = (ids >= 0).sum(axis=1)[table[:, 255] > 0.5]
    assert real.min() < pbvhw.LEAFW  # some leaf has pad columns

    def counts(sl):
        rc = {}
        pbvhw.bvhw_intersect(table_t, _t(o[sl]), _t(d[sl]),
                             torch.full((len(o[sl]),), torch.inf),
                             stackw=depth, row_counts=rc)
        return rc
    batch, one_by_one = counts(slice(None)), {}
    for i in range(len(o)):
        for key, v in counts(slice(i, i + 1)).items():
            one_by_one[key] = one_by_one.get(key, 0) + v
    assert batch == one_by_one
    assert batch["interior"] >= len(o) and batch["leaf"] > 0
    assert batch["interior"] <= batch["slabs"] <= pbvhw.BW * batch["interior"]
    assert batch["leaf"] <= batch["triangles"] <= real.max() * batch["leaf"]
    # dead lanes do no work
    dead = {}
    pbvhw.bvhw_intersect(table_t, _t(o), _t(d), torch.zeros(len(o)),
                         stackw=depth, row_counts=dead)
    assert dead == dict(interior=0, leaf=0, slabs=0, triangles=0)


def test_plain_bvhw_dead_lanes_and_wrapper():
    """t_max <= 0 lanes report no hit; on CPU tensors the K2 wrapper is
    the plain version and launches nothing; bad inputs raise."""
    p, table, depth, o, d = _case(600, n=64)
    t_max = torch.zeros(64)
    t_max[::2] = torch.inf
    before = bvhw_cu.LAUNCHES
    got = bvhw_cu.bvhw_intersect(_t(table), _t(o), _t(d), t_max,
                                 stackw=depth)
    want = pbvhw.bvhw_intersect(_t(table), _t(o), _t(d), t_max,
                                stackw=depth)
    assert bvhw_cu.LAUNCHES == before
    assert not got["valid"][1::2].any() and got["valid"][::2].any()
    assert bool((got["t"][1::2] == 0).all() and (got["tri"][1::2] == 0).all())
    for key in want:
        assert torch.equal(got[key], want[key])
    with pytest.raises(ValueError, match="stackw"):
        bvhw_cu.bvhw_intersect(_t(table), _t(o), _t(d), t_max, stackw=11)
    with pytest.raises(TypeError, match="float32"):
        bvhw_cu.bvhw_intersect(_t(table).double(), _t(o), _t(d), t_max)
    with pytest.raises(ValueError, match="table"):
        bvhw_cu.bvhw_intersect(_t(table)[:, :200], _t(o), _t(d), t_max)


def test_reorder_triangles_matches_jax():
    """The permutation of every triangle field and the light_tri remap."""
    _, jsd = jbox_field((16, 9), n_boxes=12)
    sd = scene_from_reference(jsd, device="cpu")
    order = np.random.default_rng(2).permutation(int(sd.p0.shape[0]))
    got = reorder_triangles(sd, order)
    want = jreorder(jsd, order)
    assert_scene_equal(got, want)
    # the area lights still point at their (moved) emissive triangles
    lt = got.light_tri.numpy()
    assert (lt >= 0).all()
    np.testing.assert_array_equal(got.area_light_id.numpy()[lt],
                                  np.arange(len(lt)))


def test_traced_scene_bvh_matches_jax():
    """TracedScene.create's BVH branch gives the reference's reordered
    scene, table and depth; interop carries the reference's own."""
    _, jsd = jbox_field((16, 9), n_boxes=40)
    jts = JTracedScene.create(jsd, use_pallas=False)
    ts = TracedScene.create(scene_from_reference(jsd, device="cpu"))
    assert ts.bw_rows is not None and ts.bw_depth == jts.bw_depth
    assert ts.bw_rows.numpy().tobytes() == \
        np.asarray(jts.bw_rows).tobytes()
    assert_scene_equal(ts.data, jts.data)
    for name in ("tri_attr", "light_attr", "mat_attr"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(jts, name)),
                                      err_msg=name)
    ts2 = traced_scene_from_reference(jts, device="cpu")
    assert torch.equal(ts2.bw_rows, ts.bw_rows)
    assert ts2.bw_depth == ts.bw_depth


def test_alpha_scene_above_128_raises():
    _, jsd = jbox_field((16, 9), n_boxes=12)
    sd = scene_from_reference(jsd, device="cpu")
    sd.tri_alpha_txd[0] = 0
    with pytest.raises(NotImplementedError, match="10b"):
        TracedScene.create(sd)
