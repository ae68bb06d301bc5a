"""The port's alpha-mask path against the JAX package's.

The five cases of ``tests/test_alpha.py`` run again on the port. Then each
route of a masked scene answers the same rays in both packages: the
brute-force route (K1's plain version with re-spawn retries), the dense
pass of the split BVH route (at most 512 masked triangles), the alpha
subset's own BVH32 table with re-spawn retries (above 512) and the binary
tree of a scene whose every triangle is masked. ``valid`` and ``tri`` must
be equal, ``t`` and ``b`` within rtol 1e-5 / atol 1e-6 (on lanes that
re-spawned, ``t`` within rtol 1e-4 and ``b`` within 1e-4: the alpha tree
sums t over re-spawns, the brute-force route measures it from the last
re-spawn origin, and both trace from a re-spawned origin that carries the
rounding of the first hit's point), occlusion equal. ``pack_alpha_tri``
and ``TracedScene.create``'s tables are held to the reference's leaf for
leaf, Sponza's included; Sponza's film to its golden; and a synthetic film
to the JAX film at the cornell golden's bar (RMSE < 1e-3, alpha rtol
1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel.bvh import _alpha_test_inline as j_alpha_test
from pathtracer_tpu.core.camera import Camera as JCamera
from pathtracer_tpu.integrator import PathConfig as JPathConfig
from pathtracer_tpu.integrator import PathIntegrator as JPathIntegrator
from pathtracer_tpu.integrator import TracedScene as JTracedScene
from pathtracer_tpu.integrator import _scene_intersect as j_intersect
from pathtracer_tpu.integrator import _scene_intersect_p as j_intersect_p
from pathtracer_tpu.scene.gltf import load_gltf as jload_gltf
from pathtracer_tpu.scene.scene import SceneBuilder as JSceneBuilder
from pathtracer_tpu.scene.scene import pack_alpha_tri as j_pack_alpha_tri
from pathtracer_tpu_torch import integrator as pint
from pathtracer_tpu_torch.accel.bvh import _alpha_test_inline
from pathtracer_tpu_torch.core.camera import Camera
from pathtracer_tpu_torch.core.film import to_rgb
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene, _alpha_cut,
                                             _alpha_tree_isect, _closest_raw,
                                             _scene_intersect,
                                             _scene_intersect_p)
from pathtracer_tpu_torch.interop import (camera_from_reference,
                                          traced_scene_from_reference)
from pathtracer_tpu_torch.ops.cuda.bvhw_cu import bvhw_intersect
from pathtracer_tpu_torch.scene.gltf import load_gltf
from pathtracer_tpu_torch.scene.scene import (AP_BASE, AP_WIDTH, MAT_MATTE,
                                              SceneBuilder, pack_alpha_tri)
from torch_alpha_scenes import (IDX, ROUTES, UV, build, cutout_fill,
                                foliage_rays, rays, sheets_fill)
from torch_leaves import assert_scene_equal

torch.set_num_threads(1)

def _cutout_scene(alpha_img, use_bvh=None):
    return TracedScene.create(build(SceneBuilder, cutout_fill(alpha_img)),
                              use_bvh=use_bvh)


def _respawned(ts, o, d, t_max):
    """Lanes whose first query of the alpha path hit a zero-alpha texel,
    so their t went through a re-spawn."""
    if ts.bwa_rows is not None:
        hit = bvhw_intersect(ts.bw_rows, o, d, t_max, stackw=ts.bw_depth)
        t2 = torch.where(hit["valid"], hit["t"], t_max)
        return _alpha_cut(ts, _alpha_tree_isect(ts, o, d, t2))[0]
    if not ts.use_bvh:
        return _alpha_cut(ts, _closest_raw(ts, o, d, t_max))[0]
    return torch.zeros(o.shape[0], dtype=torch.bool)


def _assert_hits_match(got, want, respawned):
    valid = got["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["tri"].numpy(), np.asarray(want["tri"]))
    t, t_want = got["t"].numpy(), np.asarray(want["t"])
    again = respawned.numpy()
    np.testing.assert_allclose(t[~again], t_want[~again], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t[again], t_want[again], rtol=1e-4)
    b, b_want = got["b"].numpy(), np.asarray(want["b"])
    once = valid & ~again
    np.testing.assert_allclose(b[once], b_want[once], rtol=1e-5, atol=1e-6)
    # a re-spawned hit's b is measured from the re-spawned origin, which
    # carries the rounding of the first hit's point
    np.testing.assert_allclose(b[valid & again], b_want[valid & again],
                               rtol=1e-4, atol=1e-4)


def _both(route):
    fill, use_bvh, _ = ROUTES[route]
    ts = TracedScene.create(build(SceneBuilder, fill), use_bvh=use_bvh)
    jts = JTracedScene.create(build(JSceneBuilder, fill), use_bvh=use_bvh,
                              use_pallas=False)
    return ts, jts


# --- the five cases of tests/test_alpha.py, on the port


def test_closest_hit_passes_through_zero_alpha():
    alpha = np.zeros((8, 8), np.float32)
    alpha[:, 4:] = 1.0  # u >= 0.5 (x >= 0 on the quad) opaque
    ts = _cutout_scene(alpha)
    o = torch.tensor([[-1.0, 2.0, 0.0], [1.0, 2.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]] * 2)
    hit = _scene_intersect(ts, o, d, torch.full((2,), torch.inf))
    assert bool(hit["valid"].all())
    tri = hit["tri"].numpy()
    assert tri[0] in (0, 1), f"masked texel should be skipped, hit {tri[0]}"
    assert tri[1] in (2, 3), f"opaque texel should block, hit {tri[1]}"


def test_shadow_rays_pass_through_zero_alpha():
    alpha = np.zeros((8, 8), np.float32)
    alpha[:, 4:] = 1.0
    ts = _cutout_scene(alpha)
    o = torch.tensor([[-1.0, 0.01, 0.0], [1.0, 0.01, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]] * 2)
    occ = _scene_intersect_p(ts, o, d, torch.full((2,), 2.9)).numpy()
    assert not occ[0], "zero-alpha texel must not occlude"
    assert occ[1], "opaque texel must occlude"


def test_bvh_inline_alpha_matches_retry_path():
    """The BVH route's mask test (here the dense pass's inline test)
    agrees with the brute-force route's re-spawn retries, bilinear edges
    included; the BVH route reports the true t."""
    rng = np.random.default_rng(7)
    alpha = (rng.random((16, 16)) < 0.5).astype(np.float32)
    ts_brute = _cutout_scene(alpha, use_bvh=False)
    ts_bvh = _cutout_scene(alpha, use_bvh=True)
    n = 256
    o = torch.tensor(np.stack([rng.uniform(-3, 3, n), np.full(n, 2.5),
                               rng.uniform(-3, 3, n)], -1),
                     dtype=torch.float32)
    d = torch.tensor([[0.0, -1.0, 0.0]] * n)
    t_inf = torch.full((n,), torch.inf)
    h1 = _scene_intersect(ts_brute, o, d, t_inf)
    h2 = _scene_intersect(ts_bvh, o, d, t_inf)
    np.testing.assert_array_equal(h1["valid"].numpy(), h2["valid"].numpy())
    ok = h1["valid"].numpy()
    m1 = ts_brute.data.material_id.numpy()[h1["tri"].numpy()]
    m2 = ts_bvh.data.material_id.numpy()[h2["tri"].numpy()]
    np.testing.assert_array_equal(m1[ok], m2[ok])
    y_hit = o[:, 1].numpy()[ok] - h2["t"].numpy()[ok]
    np.testing.assert_allclose(y_hit, np.where(m2[ok] == 1, 1.0, 0.0),
                               atol=1e-4)
    t24 = torch.full((n,), 2.4)
    np.testing.assert_array_equal(_scene_intersect_p(ts_brute, o, d, t24),
                                  _scene_intersect_p(ts_bvh, o, d, t24))


def test_cutout_render_shadows():
    """The floor under the masked half is lit, under the opaque half
    shadowed."""
    alpha = np.zeros((8, 8), np.float32)
    alpha[:, 4:] = 1.0
    ts = _cutout_scene(alpha)
    cam = Camera.look_at([0, 4.0, 4.5], [0, 0, 0], [0, 1, 0], np.pi / 3,
                         (48, 48))
    film = PathIntegrator(PathConfig(max_depth=1), spp=4).render(cam, ts)
    rgb = to_rgb(film).numpy()
    assert np.isfinite(rgb).all()
    mid = rgb[28:40]
    left, right = mid[:, 8:20].mean(), mid[:, 28:40].mean()
    assert left > 2.0 * right, (left, right)


def test_alpha_b8_tree_matches_brute():
    """Above 512 masked triangles the subset's own BVH32 table with
    re-spawn retries answers as the brute-force retry route does, on the
    checkerboard sheets of tests/test_alpha.py."""
    rng = np.random.default_rng(7)
    alpha = np.zeros((4, 4), np.float32)
    alpha[::2, ::2] = 1.0
    alpha[1::2, 1::2] = 1.0

    def fill(b):
        floor = b.add_material(mtype=MAT_MATTE, kd=(0.8, 0.8, 0.8))
        leaf_m = b.add_material(mtype=MAT_MATTE, kd=(0.2, 0.8, 0.2))
        a_txd = b.add_texture_image(np.repeat(alpha[..., None], 3, -1))
        b.add_mesh(np.array([[-12, 0, -12], [12, 0, -12], [12, 0, 12],
                             [-12, 0, 12]], np.float32), IDX, None, UV, floor)
        for gy, height in ((0, 1.0), (1, 1.55)):
            for i in range(18):
                for j in range(9):
                    cx = -9.0 + i + 0.3 * gy
                    cz = -9.0 + 2 * j + 0.2 * gy
                    q = np.array([[cx, height, cz], [cx + 1, height, cz],
                                  [cx + 1, height, cz + 1],
                                  [cx, height, cz + 1]], np.float32)
                    b.add_mesh(q, IDX, None, UV, leaf_m, alpha_txd=a_txd)
    sd = build(SceneBuilder, fill)
    ts_tree = TracedScene.create(sd)
    assert ts_tree.bwa_rows is not None, "alpha set must route to the tree"
    ts_brute = TracedScene.create(sd, use_bvh=False)
    n = 128
    o = torch.tensor(np.stack([rng.uniform(-8, 8, n), np.full(n, 3.0),
                               rng.uniform(-8, 8, n)], -1),
                     dtype=torch.float32)
    d = torch.tensor([[0.0, -1.0, 0.0]] * n)
    t_inf = torch.full((n,), torch.inf)
    h_t = _scene_intersect(ts_tree, o, d, t_inf)
    h_b = _scene_intersect(ts_brute, o, d, t_inf)
    assert torch.equal(h_t["valid"], h_b["valid"])
    assert torch.equal(h_t["tri"], h_b["tri"])
    o2 = torch.tensor(np.stack([rng.uniform(-8, 8, n), np.full(n, 0.01),
                                rng.uniform(-8, 8, n)], -1),
                      dtype=torch.float32)
    d2 = torch.tensor([[0.0, 1.0, 0.0]] * n)
    t5 = torch.full((n,), 5.0)
    assert torch.equal(_scene_intersect_p(ts_tree, o2, d2, t5),
                       _scene_intersect_p(ts_brute, o2, d2, t5))


# --- every route in both packages, on the same rays


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax(route):
    ts, jts = _both(route)
    field = ROUTES[route][2]
    assert ts.has_alpha and jts.has_alpha
    if field is None:
        assert not ts.use_bvh
    else:
        assert getattr(ts, field) is not None and getattr(ts, field) \
            is not False
    if route == "dense":
        assert ts.bwa_rows is None
    o, d, o2, d2, t2 = rays(len(route))
    t_inf = np.full(o.shape[0], np.inf, np.float32)
    pt = [torch.as_tensor(a) for a in (o, d, t_inf, o2, d2, t2)]
    jt = [jnp.asarray(a) for a in (o, d, t_inf, o2, d2, t2)]
    counts = dict(pint.RETRY_COUNTS)
    got = _scene_intersect(ts, *pt[:3])
    want = j_intersect(jts, *jt[:3])
    _assert_hits_match(got, want, _respawned(ts, *pt[:3]))
    assert got["valid"].any() and (~got["valid"]).sum() < len(o)
    occ = _scene_intersect_p(ts, *pt[3:])
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(j_intersect_p(jts, *jt[3:])))
    assert occ.any() and not occ.all()
    if route in ("brute", "tree"):  # these rays do re-spawn
        assert pint.RETRY_COUNTS["passes"] > counts["passes"]
    # the reference's own tables, carried across, trace the same
    ts2 = traced_scene_from_reference(jts, device="cpu")
    got2 = _scene_intersect(ts2, *pt[:3])
    for key in got:
        assert torch.equal(got2[key], got[key]), key


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_dead_lanes_test_nothing(route):
    """Lanes outside ``live`` get a miss and report no occlusion, on every
    route, and the live lanes' answers do not change."""
    ts, _ = _both(route)
    o, d, o2, d2, t2 = (torch.as_tensor(a) for a in rays(11, n=128))
    live = torch.arange(128) % 3 != 0
    full = _scene_intersect(ts, o, d, torch.inf)
    part = _scene_intersect(ts, o, d, torch.inf, live=live)
    assert not part["valid"][~live].any()
    for key in full:
        assert torch.equal(part[key][live], full[key][live]), key
    occ = _scene_intersect_p(ts, o2, d2, t2, live=live)
    assert not occ[~live].any()
    assert torch.equal(occ[live], _scene_intersect_p(ts, o2, d2, t2)[live])


# --- the tables


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_create_builds_the_reference_tables(route):
    ts, jts = _both(route)
    _assert_tables_equal(ts, jts)


def test_create_above_dense_cap_orders_the_subset_by_its_tree():
    """Above 1,536 masked triangles the subset goes in the order of its
    own SAH tree before its BVH32 table is built."""
    fill = sheets_fill(28, 28)
    sd = build(SceneBuilder, fill)
    assert int((sd.tri_alpha_txd >= 0).sum()) > pint.DENSE_CAP
    ts = TracedScene.create(sd)
    jts = JTracedScene.create(build(JSceneBuilder, fill), use_pallas=False)
    assert jts.bvh_alpha is not None
    _assert_tables_equal(ts, jts)


def _assert_tables_equal(ts, jts):
    assert_scene_equal(ts.data, jts.data)
    assert (ts.has_alpha, ts.split_alpha, ts.n_opaque, ts.bw_depth,
            ts.bwa_depth) == (jts.has_alpha, jts.split_alpha, jts.n_opaque,
                              jts.bw_depth, jts.bwa_depth)
    for name in ("bw_rows", "bwa_rows", "bwa_map", "alpha_pack",
                 "alpha_texels", "tri_attr"):
        got, want = getattr(ts, name), getattr(jts, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.numpy().dtype == np.asarray(want).dtype, name
            assert got.numpy().tobytes() == np.asarray(want).tobytes(), name
    if jts.bw_rows is None and jts.bvh is not None:
        assert ts.bvh_nodes.numpy().tobytes() == \
            np.asarray(jts.bvh.nodes).tobytes()
        assert ts.max_leaf == jts.bvh.max_leaf
    else:
        assert ts.bvh_nodes is None


def test_pack_alpha_tri_matches_reference_above_2_24():
    """The rows leaf for leaf, and a pool offset above 2^24 carried as
    int32 bits: 2^24 + 3 has no f32 value, its bit pattern is exact."""
    alpha = np.zeros((8, 8), np.float32)
    alpha[:, 4:] = 1.0
    sd = build(SceneBuilder, cutout_fill(alpha))
    jsd = build(JSceneBuilder, cutout_fill(alpha))
    assert j_pack_alpha_tri(jsd)[0] is not None
    big = (1 << 24) + 3
    sd = dataclasses.replace(sd, tex=dataclasses.replace(
        sd.tex, level_offset=sd.tex.level_offset + big))
    jsd = dataclasses.replace(jsd, tex=dataclasses.replace(
        jsd.tex, level_offset=jsd.tex.level_offset + big))
    rows, texels = pack_alpha_tri(sd)
    j_rows, j_texels = j_pack_alpha_tri(jsd)
    assert rows.shape == (4, AP_WIDTH) and rows.dtype == np.float32
    assert rows.tobytes() == np.asarray(j_rows).tobytes()
    np.testing.assert_array_equal(texels, np.asarray(j_texels))
    base = rows[:, AP_BASE].view(np.int32)
    assert (base[2:] == big).all()  # the masked quad's mask at level 0
    assert float(np.float32(big)) != big
    # no mask: no rows
    sd_plain = dataclasses.replace(sd, tri_alpha_txd=torch.full_like(
        sd.tri_alpha_txd, -1))
    assert pack_alpha_tri(sd_plain) == (None, None)


def test_inline_test_reads_texels_above_2_24():
    """The inline mask test of a row whose level 0 starts past 2^24
    texels reads the texels there (a float base would land 3 off), as the
    reference's does."""
    rng = np.random.default_rng(5)
    big = (1 << 24) + 3
    texels = np.ones(big + 64, np.float32)
    mask = (rng.random(64) < 0.5).astype(np.float32)
    texels[big:] = mask
    texels[big - 3:big] = 0.0  # a base rounded to 2^24 would read these
    rows = np.zeros((1, AP_WIDTH), np.float32)
    rows[0, 0:6] = [0, 0, 1, 0, 0, 1]  # uv0, uv1, uv2
    rows[0, 6:8] = [1, 1]  # su, sv
    rows[0, AP_BASE] = np.array([big], np.int32).view(np.float32)[0]
    rows[0, 11:15] = [8, 8, 0, 1]  # w, h, wrap repeat, flag
    n = 512
    b = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    pid = np.zeros(n, np.int32)
    got = _alpha_test_inline(torch.as_tensor(rows), torch.as_tensor(texels),
                             torch.as_tensor(pid), torch.as_tensor(b))
    want = j_alpha_test(jnp.asarray(rows), jnp.asarray(texels),
                        jnp.asarray(pid), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("wrap", [0, 1, 2])
def test_inline_test_wrap_modes_match_reference(wrap):
    """Repeat, black and clamp outside [0, 1) uv."""
    rng = np.random.default_rng(wrap)
    texels = (rng.random(40) < 0.5).astype(np.float32)
    rows = np.zeros((2, AP_WIDTH), np.float32)
    rows[:, 0:6] = [-1.3, -0.7, 2.1, -0.4, 0.2, 1.9]
    rows[:, 6:10] = [1.5, 1.0, 0.1, -0.2]
    rows[:, AP_BASE] = np.array([4, 4], np.int32).view(np.float32)
    rows[:, 11:14] = [6, 6, wrap]
    rows[:, 14] = [1, 0]  # the second row carries no mask: it survives
    n = 400
    b = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    pid = (np.arange(n) % 2).astype(np.int32)
    got = _alpha_test_inline(torch.as_tensor(rows), torch.as_tensor(texels),
                             torch.as_tensor(pid), torch.as_tensor(b))
    want = j_alpha_test(jnp.asarray(rows), jnp.asarray(texels),
                        jnp.asarray(pid), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[1::2].all() and not got.numpy()[0::2].all()


# --- Sponza


@pytest.mark.slow
def test_sponza_routes_match_jax():
    """Sponza's split route (main table, then the alpha subset's table
    with re-spawn retries) on rays through its foliage, closest and any
    hit, in both packages (the JAX traversals compile: slow)."""
    _, sd, _ = load_gltf("data/sponza_proc.glb", resolution=(32, 18),
                         device="cpu")
    _, jsd, _ = jload_gltf("data/sponza_proc.glb", resolution=(32, 18))
    ts = TracedScene.create(sd)
    jts = JTracedScene.create(jsd, use_pallas=False)
    o, d = foliage_rays(ts.data, 256)
    t_inf = np.full(256, np.inf, np.float32)
    t_any = np.full(256, 4.0, np.float32)
    pt = [torch.as_tensor(a) for a in (o, d, t_inf, t_any)]
    jt = [jnp.asarray(a) for a in (o, d, t_inf, t_any)]
    got = _scene_intersect(ts, *pt[:3])
    again = _respawned(ts, *pt[:3])
    _assert_hits_match(got, j_intersect(jts, *jt[:3]), again)
    assert 0 < int(again.sum()) < 256 and int(got["valid"].sum()) > 128
    occ = _scene_intersect_p(ts, pt[0], pt[1], pt[3])
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(j_intersect_p(jts, jt[0], jt[1], jt[3])))


def test_sponza_48_matches_golden():
    """Sponza at 48x27, 2 spp, depth 1 ("ref" MIS) on the CPU against the
    committed golden (the JAX film), at the bar of the reference's
    ``test_sponza_glb_golden`` (weights rtol 1e-5, mean within 3 %, under
    10 % of channels more than 5 % off) and at RMSE < 1e-3."""
    cam, sd, _ = load_gltf("data/sponza_proc.glb", resolution=(48, 27),
                           device="cpu")
    counts = dict(pint.RETRY_COUNTS)
    film = PathIntegrator(PathConfig(max_depth=1), spp=2).render(
        cam, sd).numpy()
    ref = np.load("tests/golden_sponza_48.npz")["film"]
    np.testing.assert_allclose(film[..., 3], ref[..., 3], rtol=1e-5)
    f, r = film[..., :3], ref[..., :3]
    assert abs(f.mean() - r.mean()) < 0.03 * r.mean() + 1e-4
    assert (np.abs(f - r) / (np.abs(r) + 5e-2) > 0.05).mean() < 0.10
    assert np.sqrt(np.mean((f - r) ** 2)) < 1e-3
    # the foliage re-spawned some lanes through its table
    assert pint.RETRY_COUNTS["passes"] > counts["passes"]
    assert pint.RETRY_COUNTS["alpha_tree"] > counts["alpha_tree"]


# --- films


def _cutout_camera():
    return JCamera.look_at([0, 4.0, 4.5], [0, 0, 0], [0, 1, 0], np.pi / 3,
                           (32, 32))


@pytest.mark.slow
@pytest.mark.parametrize("route", ["brute", "dense"])
def test_alpha_film_matches_jax_film(route):
    """A masked scene rendered by both packages (depth 2, "ref" MIS):
    RMSE < 1e-3, alpha rtol 1e-5 (the JAX render compiles: slow)."""
    fill = sheets_fill(4, 4, heights=(1.0,)) if route == "brute" else \
        ROUTES["dense"][0]
    use_bvh = route != "brute"
    ts = TracedScene.create(build(SceneBuilder, fill), use_bvh=use_bvh)
    jts = JTracedScene.create(build(JSceneBuilder, fill), use_bvh=use_bvh,
                              use_pallas=False)
    assert ts.use_bvh == use_bvh
    cam = _cutout_camera()
    jcam = camera_from_reference(cam)
    film = PathIntegrator(PathConfig(max_depth=2), spp=2).render(
        jcam, ts).numpy()
    jfilm = np.asarray(JPathIntegrator(JPathConfig(max_depth=2),
                                       spp=2).render(cam, jts))
    np.testing.assert_allclose(film[..., 3], jfilm[..., 3], rtol=1e-5)
    rmse = np.sqrt(np.mean((film[..., :3] - jfilm[..., :3]) ** 2))
    assert rmse < 1e-3, rmse
    assert film[..., :3].mean() > 0
