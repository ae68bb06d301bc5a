"""The ``tankfarm-spheres`` configuration: four spheres (rough glass,
mirror, rough metal, rough plastic) on a diffuse ground under the
published HDR environment (``benchmark/scenes/tankfarm-spheres.xml``), on
the port's normal path, against the benchmark's plain reference
(``benchmark/reference/env_path.py`` with its reader ``env_scene.py``),
and the span and counter its cell reads: ``pt::env`` and
``PathIntegrator.env_lanes``.

The reference takes its tables, its map coordinates and its rough
glass's products as the port does (its docstring says where and why), so
its tables, environment sampling and BSDFs are held to the port's bit
for bit, and its films to the port's under the cell's own limits.

The tests marked ``cuda`` need a card (they skip without one): graph
replay against eager on the new scene, with the counter. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_tankfarm.py
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer_tpu_torch import integrator as pint
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene)
from pathtracer_tpu_torch.ops import bsdf as bx
from pathtracer_tpu_torch.ops import lights as lt
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.scene import (LIGHT_INFINITE, MA_ETA, MA_K,
                                              MA_KD, MA_KS, MA_ROUGH,
                                              MAT_MATTE, MAT_METAL,
                                              MAT_MIRROR, MAT_ROUGHGLASS,
                                              MAT_SUBSTRATE, pack_mat_attr)
from pathtracer_tpu_torch.utils.image import read_hdr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SCENE = os.path.join(BENCH, "scenes", "tankfarm-spheres.xml")
HDR = os.path.join(ROOT, "data", "abandoned_tank_farm_04_1k.hdr")
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")
CELL = "tankfarm-spheres-640-d15"
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import env_path as ep  # noqa: E402
from reference import env_scene as es  # noqa: E402
from reference import sphere_scene as ss  # noqa: E402

torch.set_num_threads(1)

PORT_TYPE = {es.ROUGHGLASS: MAT_ROUGHGLASS, es.MIRROR: MAT_MIRROR}


@pytest.fixture(scope="module")
def tankfarm():
    """The scene at 16 x 12 on the CPU, and the reference's environment."""
    cam, sd, _ = load_mitsuba(SCENE, resolution=(16, 12), device="cpu")
    tris = es.load(SCENE)
    return cam, sd, ep.Environment(tris["env"], "cpu")


# ------------------------------------------------------------ the BSDFs
def _lanes(kind, n=4096, seed=11):
    """Seeded lanes of one material: wo, wi on the whole sphere (so wo
    both enters and leaves), u in [0, 1)^2, alpha in [0.01, 1], the
    interior eta in [1.2, 2]; as the port's parameter dict and the
    reference's row."""
    g = np.random.default_rng(seed + kind)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def unit():
        v = g.normal(size=(n, 3))
        return t(v / np.linalg.norm(v, axis=1, keepdims=True))

    wo, wi = unit(), unit()
    u = t(g.uniform(0.0, 1.0, (n, 2)))
    alpha = t(g.uniform(0.01, 1.0, n))
    eta = t(np.repeat(g.uniform(1.2, 2.0, n)[:, None], 3, 1))
    ones, zeros = t(np.ones((n, 3))), t(np.zeros((n, 3)))
    mp = dict(mtype=torch.full((n,), PORT_TYPE[kind], dtype=torch.int32),
              kd=ones, ks=ones, eta3=eta, eta=eta[:, 0], k=zeros, ax=alpha,
              ay=alpha, metallic=torch.zeros(n))
    row = dict(mtype=torch.full((n,), kind), kd=ones, ks=ones, eta=eta,
               k=zeros, alpha=alpha)
    # the geometric normal's verdict, drawn apart from the shading frame's
    reflect = t(g.uniform(-1.0, 1.0, n)) > -0.2
    return mp, row, wo, wi, u, reflect


@pytest.mark.parametrize("kind", [es.ROUGHGLASS, es.MIRROR],
                         ids=["rough_glass", "mirror"])
def test_bsdf_equals_the_reference_bit_for_bit(kind):
    """The port's f, pdf and sample of rough glass and the mirror against
    the reference's, on seeded random directions entering and leaving,
    samples, roughness (alpha in [0.01, 1]) and eta, with a geometric
    normal that disagrees with the shading frame on some lanes.
    Tolerance: none. Both compute in float32 with the same products in
    the same order and a correctly rounded root, so any gap is a change
    of formula; and a gap of one bit in beta can move the roulette, which
    the cell's check would read as a path taking another turn."""
    mp, row, wo, wi, u, reflect = _lanes(kind)
    assert (wo[:, 2] > 0).any() and (wo[:, 2] < 0).any()
    f, pdf = bx.eval_f_pdf(mp, wo, wi, reflect, present=(PORT_TYPE[kind],))
    f_ref, pdf_ref = ep.eval_f_pdf(row, wo, wi, reflect)
    assert torch.equal(f, f_ref) and torch.equal(pdf, pdf_ref)

    def ng_test(w):  # a verdict on the sampled direction of its own
        return w[:, 0] + 0.3 * w[:, 2] > -0.1

    got = bx.sample_f(mp, wo, u, ng_test, present=(PORT_TYPE[kind],))
    want = ep.sample_f(row, wo, u, ng_test)
    for key in ("wi", "f", "pdf", "specular", "transmission"):
        assert torch.equal(got[key], want[key]), key
    if kind == es.MIRROR:  # specular: nothing for the light's branch
        assert not f.any() and not pdf.any()
        assert got["specular"].all() and (got["pdf"] == 1.0).all()
        return
    assert (pdf > 0).float().mean() > 0.4 and torch.isfinite(f).all()
    assert not got["specular"].any()
    assert (got["pdf"] > 0).float().mean() > 0.6
    # both lobes sampled, from both sides
    same = got["wi"][:, 2] * wo[:, 2] > 0
    ok = got["pdf"] > 0
    for side in (wo[:, 2] > 0, wo[:, 2] < 0):
        assert (ok & side & same).any() and (ok & side & ~same).any()


# ----------------------------------------------------- the environment
def test_rgbe_reader_equals_the_ports():
    """The reference's own RGBE decoder gives the port's
    ``utils/image.read_hdr`` bit for bit on the repo's HDR (1024 x 512,
    run-length encoded). Tolerance: none; both decode m * 2^(e - 136),
    exact in float32."""
    got = es.read_rgbe(HDR)
    want = read_hdr(HDR)
    assert got.dtype == np.float32 and got.shape == (512, 1024, 3)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 1000.0 and (got > 0).mean() > 0.99


def test_tables_equal_the_ports_bit_for_bit(tankfarm):
    """pbrt's ``Distribution2D`` of the map as the reference builds it
    (its sequential float32 cdf) against the port's tables, and the
    rotation both ways. Tolerance: none; a cdf entry one ulp off moves
    the cell that a u landing on it picks (``env_path``'s docstring)."""
    _, sd, env = tankfarm
    assert tuple(env.cond_cdf.shape) == (1024, 2049)
    for name in ("cond_func", "cond_cdf", "cond_int", "marg_func",
                 "marg_cdf", "marg_int"):
        got = getattr(env, name)
        want = torch.as_tensor(getattr(sd, "env_" + name))
        assert got.shape == want.shape and torch.equal(got, want), name
    assert torch.equal(env.l2w, sd.env_to_world)
    assert torch.equal(env.w2l, sd.world_to_env)
    assert torch.equal(env.marg_cdf[-1], torch.tensor(1.0))


def _edge_directions(env):
    """Directions at the map's edges: the two poles, either side of the u
    seam and on it, and exactly level (world y = 0) ones."""
    l2w = env.l2w.double()
    pole = l2w[:, 2]
    seam = []
    for phi in (0.0, 1e-7, -1e-7, 1e-3, -1e-3):
        for theta in (0.5, np.pi / 2, 2.5):
            local = torch.tensor([np.sin(theta) * np.cos(phi),
                                  np.sin(theta) * np.sin(phi),
                                  np.cos(theta)], dtype=torch.float64)
            seam.append(l2w @ local)
    level = [torch.tensor([1.0, 0.0, 0.0]), torch.tensor([0.0, 0.0, -1.0]),
             torch.tensor([-0.6, 0.0, 0.8])]
    return torch.stack([pole, -pole] + seam + [v.double() for v in level]
                       ).float()


def test_sample_pdf_and_le_equal_the_ports(tankfarm):
    """``sample_li``, ``pdf_li`` and ``Le`` of the reference against the
    port's on seeded u and directions, and on the edge directions: the
    poles, the u seam, and level ones. An exactly level direction lands
    on row 512 of 1,024 in both (v = 0.5: the rotation's 6e-17 entries
    leave its map z at 0 or below an ulp of theta), the seam on column 0
    or 2,047. Tolerance: none; the same ops on the same tables."""
    _, sd, env = tankfarm
    g = torch.Generator().manual_seed(5)
    u = torch.rand(20000, 2, generator=g)
    u[:4] = torch.tensor([[0.0, 0.0], [0.0, 0.99999994], [0.99999994, 0.0],
                          [0.5, 0.5]])
    for got, want in zip(env.sample_li(u), lt._env_sample_li(sd, u)):
        assert torch.equal(got, want)
    wi, pdf, li = env.sample_li(u)
    assert (pdf > 0).float().mean() > 0.999 and (li > 0).any(-1).all()
    d = torch.nn.functional.normalize(torch.randn(20000, 3, generator=g),
                                      dim=-1)
    edges = _edge_directions(env)
    for dirs in (d, edges, wi):
        assert torch.equal(env.pdf_li(dirs), lt.env_pdf_li(sd, dirs))
        assert torch.equal(env.le(dirs), lt.env_le(sd, dirs))
    nv, nu = env.cond_func.shape
    uv, _ = env.uv(edges)
    rows = (uv[:, 1] * nv).long().clamp(0, nv - 1)
    cols = (uv[:, 0] * nu).long().clamp(0, nu - 1)
    assert rows[-3:].tolist() == [512, 512, 512]
    assert rows[:2].tolist() == [0, nv - 1]
    assert set(cols[2:-3].tolist()) <= {0, 1, nu - 2, nu - 1}
    # a density over the sphere: the mean of 1 / pdf over the samples
    # estimates its 4 pi steradians (Monte Carlo: a standard error of
    # 1.4 % at 20,000 samples, so 5 %); a sample's density is ``pdf_li``
    # at its direction, but where the direction rounds into the next
    # cell (rtol 1e-4, on all but 0.1 % of the samples)
    pdf, wi = pdf[4:], wi[4:]  # the seeded u alone
    assert abs(float((1.0 / pdf).mean() / (4.0 * np.pi)) - 1.0) < 0.05
    assert torch.isclose(env.pdf_li(wi), pdf, rtol=1e-4).float().mean() \
        > 0.999


# --------------------------------------------------------- the scene file
def test_xml_loads_to_the_stated_rows():
    """722 triangles, one infinite light and no area light, no alpha; the
    material rows the configuration states; the reference's reader makes
    the same triangles and materials."""
    _, sd, settings = load_mitsuba(SCENE, resolution=(32, 24), device="cpu")
    assert sd.p0.shape[0] == 722 and int(sd.n_lights) == 1
    assert sd.light_type.tolist() == [LIGHT_INFINITE] and bool(sd.has_env)
    assert not (sd.area_light_id >= 0).any()
    assert not (sd.tri_alpha_txd >= 0).any()
    assert settings["spp"] == 64 and settings["film"] == (640, 480)
    mt = sd.mat_type.numpy()
    used = sorted(set(np.unique(sd.material_id.numpy()).tolist()))
    assert sorted(set(mt[used].tolist())) == sorted(
        [MAT_MATTE, MAT_MIRROR, MAT_METAL, MAT_SUBSTRATE, MAT_ROUGHGLASS])
    attr = pack_mat_attr(sd)
    rows = {int(t): attr[list(mt).index(t)] for t in mt[used]}
    rg, metal, sub = (rows[t] for t in (MAT_ROUGHGLASS, MAT_METAL,
                                        MAT_SUBSTRATE))
    np.testing.assert_array_equal(rg[MA_ETA], np.float32([1.5] * 3))
    np.testing.assert_array_equal(rg[MA_ROUGH][:2], np.float32([0.1, 0.1]))
    np.testing.assert_array_equal(rg[MA_KD], np.float32([1.0] * 3))
    np.testing.assert_array_equal(rg[MA_KS], np.float32([1.0] * 3))
    np.testing.assert_array_equal(metal[MA_ETA],
                                  np.float32([0.2, 0.92, 1.1]))
    np.testing.assert_array_equal(metal[MA_K],
                                  np.float32([3.9, 2.45, 2.14]))
    np.testing.assert_array_equal(sub[MA_KD], np.float32([0.4, 0.2, 0.55]))
    np.testing.assert_array_equal(rows[MAT_MATTE][MA_KD],
                                  np.float32([0.5] * 3))

    tris = es.load(SCENE)
    assert len(tris["light_tri"]) == 0
    for i, p in enumerate((sd.p0, sd.p1, sd.p2)):
        np.testing.assert_array_equal(tris["p"][:, i], p.numpy())
    kinds = {MAT_MATTE: ss.MATTE, MAT_METAL: ss.METAL,
             MAT_SUBSTRATE: ss.SUBSTRATE, MAT_MIRROR: es.MIRROR,
             MAT_ROUGHGLASS: es.ROUGHGLASS}
    want = np.array([kinds[int(t)] for t in mt[sd.material_id.numpy()]])
    np.testing.assert_array_equal(tris["mtype"], want)
    assert [int((want == k).sum()) for k in (es.ROUGHGLASS, es.MIRROR,
                                             ss.METAL, ss.SUBSTRATE,
                                             ss.MATTE)] == [180] * 4 + [2]


# ---------------------------------------------------------------- films
def _cell():
    from harness import manifest

    man = manifest.load_manifest()
    entry = manifest.cell(man, CELL)
    return (manifest.config(man, entry["config"]),
            manifest.traffic(entry["traffic"]), manifest.limits(CELL))


def test_film_matches_the_reference_under_the_cells_limits():
    """The port's film of a seeded view at 32 x 24, 4 spp, depth 15
    (K2's plain traversal here) against the reference's at the seed's
    check tiles, under the cell's three limits."""
    from harness import check, workload
    from harness.program import Program

    cfg, traffic, limits = _cell()
    traffic = dict(traffic, resolution=[32, 24], job_spp=4, pass_spp=4,
                   check=dict(tiles=4, tile_px=8))
    assert traffic["max_depth"] == 15
    seed = 3000000001
    view = workload.moved_camera(cfg, traffic, seed)
    tiles = workload.check_tiles(seed, traffic)
    prog = Program(cfg, traffic, "cpu")
    assert prog.scene.use_bvh and prog.scene.has_env
    film = prog.integ.render(prog.camera(view), prog.scene)
    ref = ep.render_tiles(cfg, traffic, view, tiles, 4, "cpu")
    numbers = check.compare(check.read_tiles(film, tiles, 8),
                            check.read_tiles(ref, tiles, 8))
    correct, compared = check.judge(numbers, limits)
    assert correct, compared
    assert float(ref[..., :3].sum()) > 0


# ------------------------------------------------------- span and counter
def _spied_render(monkeypatch, cam, scene, cfg, spp=2):
    """A render of ``scene`` with the environment's calls and the lanes
    that use them counted beside the port's own count: (integrator, film,
    {"used", "run"} counted directly)."""
    direct = dict(used=0, run=0)
    closest, nee = pint._scene_intersect, pint.estimate_direct
    env_le, env_le_pdf = lt.env_le, lt.env_le_pdf
    env_sample = lt._env_sample_li

    def scene_intersect(scene_, o, d, t_max, live=None):
        hit = closest(scene_, o, d, t_max, live=live)
        # onesample: each closest-hit query is a bounce's; its live lanes
        # that miss escape to the environment
        direct["used"] += int((live & ~hit["valid"]).sum())
        return hit

    def estimate_direct(*args, live=None, **kw):
        direct["used"] += int(live.sum())  # every light is the environment
        return nee(*args, live=live, **kw)

    def widths(fn):
        def spy(scene_, x):
            direct["run"] += x.shape[0]
            return fn(scene_, x)
        return spy

    monkeypatch.setattr(pint, "_scene_intersect", scene_intersect)
    monkeypatch.setattr(pint, "estimate_direct", estimate_direct)
    monkeypatch.setattr(lt, "env_le", widths(env_le))
    monkeypatch.setattr(lt, "env_le_pdf", widths(env_le_pdf))
    monkeypatch.setattr(lt, "_env_sample_li", widths(env_sample))
    integ = PathIntegrator(cfg, spp=spp)
    film = integ.render_progressive(cam, scene, chunk_spp=1)
    return integ, film, direct


def test_env_lanes_count_the_lanes_that_use_the_environment(tankfarm,
                                                           monkeypatch):
    """On the eager path ``env_lanes`` equals a direct count: ``used``,
    the live lanes that escape plus those whose light sample is the
    environment's; ``run``, the width of every call of its code (the
    escape's radiance and density are one call a bounce, ``env_le`` or
    ``env_le_pdf``). Counting changes no film bit, and a render without the count
    gives the same film."""
    cam, sd, _ = tankfarm
    scene = TracedScene.create(sd)
    cfg = PathConfig(max_depth=15, mis_mode="onesample")
    run0 = pint.ENV_RUN
    integ, film, direct = _spied_render(monkeypatch, cam, scene, cfg)
    monkeypatch.undo()
    assert integ.env_lanes == dict(used=float(direct["used"]),
                                   run=float(direct["run"]))
    assert pint.ENV_RUN - run0 == direct["run"]
    lanes = 20 * 16 * 2  # the 20 x 16 sample rectangle, two frames
    assert direct["run"] == lanes * (16 + 15)
    assert 0 < integ.env_lanes["used"] < 0.25 * integ.env_lanes["run"]

    plain = PathIntegrator(cfg, spp=2)
    inner = plain.render_frames
    plain.render_frames = lambda su, film_pad, band, s0, n_frames, occ: \
        inner(su, film_pad, band, s0, n_frames, None)
    assert torch.equal(plain.render_progressive(cam, scene, chunk_spp=1),
                       film)
    assert plain.env_lanes == dict(used=0.0, run=float(direct["run"]))
    assert integ.bounce_occupancy.shape == (16,)
    assert integ.lane_bounces["run"] == lanes * 16.0


def test_no_environment_no_count_and_no_span():
    """cornell has no environment: ``env_lanes`` stays zero, ``ENV_RUN``
    does not move, and a profiled render opens no ``pt::env``; the
    tankfarm scene opens one at each call of the environment's code."""
    cam, sd, _ = load_mitsuba(CORNELL, resolution=(20, 16), device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=3, mis_mode="onesample"),
                           spp=2)
    run0 = pint.ENV_RUN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        integ.render(cam, sd)
    assert integ.env_lanes == dict(used=0.0, run=0.0)
    assert pint.ENV_RUN == run0
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "pt::bounce" in names and "pt::env" not in names

    cam, sd, _ = load_mitsuba(SCENE, resolution=(8, 6), device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=2, mis_mode="onesample"),
                           spp=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        integ.render(cam, sd)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    # a band-frame: 3 escapes (one call each, 2 of them with the
    # density), 2 light samples
    frames = names.count("pt::band_frame")
    assert frames > 0 and names.count("pt::env") == 5 * frames


# --------------------------------------------------------- the reference
def test_reference_imports_neither_package():
    """``env_path`` and its scene reader import nothing of
    ``pathtracer_tpu`` or ``pathtracer_tpu_torch``, in their source and
    when imported alone."""
    for name in ("env_path.py", "env_scene.py"):
        with open(os.path.join(BENCH, "reference", name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            assert not any(m.split(".")[0].startswith("pathtracer_tpu")
                           for m in mods), (name, mods)
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.env_path; import json; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('pathtracer_tpu') "
            "or m.split('.')[0] in ('jax', 'jaxlib'))))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# ------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and K2 have no CPU mode")
    return torch.device("cuda")


def _render_two(dev, engage: bool):
    """Two 160 x 120 jobs at 8 spp in chunks of 4, depth 15, through one
    integrator: (films, occupancy, env_lanes, GRAPH_COUNTS moved)."""
    cam, sd, _ = load_mitsuba(SCENE, resolution=(160, 120), device=dev)
    scene = TracedScene.create(sd)
    integ = PathIntegrator(PathConfig(max_depth=15, mis_mode="onesample"),
                           spp=8, band_rows=40)
    real = pint._graph_engages
    if not engage:
        pint._graph_engages = lambda scene, cfg: False
    before = dict(pint.GRAPH_COUNTS)
    films, occ = [], []
    try:
        for shift in (0.0, 0.04):
            c2w = cam.cam_to_world.copy()
            c2w[0, 3] += shift
            camera = dataclasses.replace(cam, cam_to_world=c2w)
            films.append(integ.render_progressive(camera, scene,
                                                  chunk_spp=4).cpu())
            occ.append(integ.bounce_occupancy.copy())
    finally:
        pint._graph_engages = real
    moved = {k: v - before[k] for k, v in pint.GRAPH_COUNTS.items()}
    return dict(films=films, occ=occ, moved=moved,
                env=dict(integ.env_lanes), lanes=dict(integ.lane_bounces))


@pytest.mark.cuda
def test_graph_films_and_counts_equal_eager(dev):
    """Graph replay against eager on the new scene (the environment's
    full-width code, K2, rough glass and the mirror, 16 bounces): films,
    live lanes and ``env_lanes`` equal, the used lanes a graph-owned
    buffer's, the run lanes the capture's tally a replay."""
    g, e = _render_two(dev, True), _render_two(dev, False)
    assert g["moved"]["replays"] > 0 and e["moved"]["replays"] == 0
    for got, want in zip(g["films"], e["films"]):
        assert torch.isfinite(got).all() and (got[..., 3] > 0).all()
        assert torch.equal(got, want)
    for got, want in zip(g["occ"], e["occ"]):
        np.testing.assert_array_equal(got, want)
    assert g["lanes"] == e["lanes"] and g["env"] == e["env"]
    assert 0 < g["env"]["used"] < g["env"]["run"]
