"""The ``cornell-spheres`` configuration: cornell's room with a rough
metal, a rough plastic and a glass sphere (``benchmark/scenes/
cornell-spheres.xml``), on the port's normal path, against the
benchmark's plain reference (``benchmark/reference/sphere_path.py``),
and the counters its cell reads: the live lanes a bounce and K2's bytes.

The reference takes every product, root and norm as the port does
(its docstring says why: Russian roulette after a glass bounce turns on
the last bit of beta), so its BSDFs are held to the port's bit for bit,
and its films to the port's under the cell's own limits.

The tests marked ``cuda`` need a card (they skip without one): graph
replay against eager on the new scene, and every K2 kernel of a traced
replay linked to its ``pt::k:bvhw`` span. The file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cornell_spheres.py
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

from pathtracer_tpu_torch import integrator as pint
from pathtracer_tpu_torch.integrator import (PathConfig, PathIntegrator,
                                             TracedScene, trace_wave)
from pathtracer_tpu_torch.ops import bsdf as bx
from pathtracer_tpu_torch.ops.cuda import _build, bvhw_cu
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.scene import (MA_ETA, MA_K, MA_KD, MA_KS,
                                              MA_ROUGH, MAT_GLASS, MAT_MATTE,
                                              MAT_METAL, MAT_SUBSTRATE,
                                              pack_mat_attr)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SCENE = os.path.join(BENCH, "scenes", "cornell-spheres.xml")
CELL = "cornell-spheres-640-d15"
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import sphere_path as sp  # noqa: E402
from reference import sphere_scene as ss  # noqa: E402

torch.set_num_threads(1)

PORT_TYPE = {ss.METAL: MAT_METAL, ss.SUBSTRATE: MAT_SUBSTRATE,
             ss.GLASS: MAT_GLASS}


# ------------------------------------------------------------ the BSDFs
def _lanes(kind, n=4096, seed=7):
    """Seeded lanes of one material: wo, wi on the whole sphere, u in
    [0, 1)^2, alpha in [0.01, 1], and the material's own random
    parameters; as the port's parameter dict and the reference's row."""
    g = np.random.default_rng(seed + kind)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def unit():
        v = g.normal(size=(n, 3))
        return t(v / np.linalg.norm(v, axis=1, keepdims=True))

    wo, wi = unit(), unit()
    u = t(g.uniform(0.0, 1.0, (n, 2)))
    alpha = t(g.uniform(0.01, 1.0, n))
    kd = t(g.uniform(0.0, 1.0, (n, 3)))
    ior = g.uniform(1.2, 2.0, n)
    ones, zeros = t(np.ones((n, 3))), t(np.zeros((n, 3)))
    if kind == ss.METAL:
        eta, k, ks = t(g.uniform(0.1, 2.0, (n, 3))), \
            t(g.uniform(0.5, 5.0, (n, 3))), t(g.uniform(0.5, 1.0, (n, 3)))
    elif kind == ss.SUBSTRATE:
        r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        eta, k, ks = ones, zeros, t(np.repeat(r0[:, None], 3, 1))
    else:
        eta, k, ks, kd = t(np.repeat(ior[:, None], 3, 1)), zeros, ones, ones
    mp = dict(mtype=torch.full((n,), PORT_TYPE[kind], dtype=torch.int32),
              kd=kd, ks=ks, eta3=eta, eta=eta[:, 0], k=k, ax=alpha,
              ay=alpha, metallic=torch.zeros(n))
    row = dict(mtype=torch.full((n,), kind), kd=kd, ks=ks, eta=eta, k=k,
               alpha=alpha)
    return mp, row, wo, wi, u


@pytest.mark.parametrize("kind", [ss.METAL, ss.SUBSTRATE, ss.GLASS],
                         ids=["metal", "substrate", "glass"])
def test_bsdf_equals_the_reference_bit_for_bit(kind):
    """The port's f, pdf and sample of each of the scene's three new
    materials against the reference's, on seeded random directions,
    samples, roughness (alpha in [0.01, 1]), eta, k and kd. Tolerance:
    none. Both compute in float32 with the same products in the same
    order and a correctly rounded root, so any gap is a change of
    formula; and a gap of one bit in beta moves the roulette after a
    glass bounce (``sphere_path``'s docstring), which the cell's check
    would read as a path taking another turn."""
    mp, row, wo, wi, u = _lanes(kind)
    reflect = wo[:, 2] * wi[:, 2] > 0.0
    f, pdf = bx.eval_f_pdf(mp, wo, wi, reflect, present=(PORT_TYPE[kind],))
    f_ref, pdf_ref = sp.eval_f_pdf(row, wo, wi, reflect)
    assert torch.equal(f, f_ref) and torch.equal(pdf, pdf_ref)
    if kind == ss.GLASS:  # specular: nothing for the light's branch
        assert not f.any() and not pdf.any()
    else:
        assert (pdf > 0).float().mean() > 0.3 and torch.isfinite(f).all()
    got = bx.sample_f(mp, wo, u, lambda w: torch.ones_like(reflect),
                      present=(PORT_TYPE[kind],))
    want = sp.sample_f(row, wo, u)
    for key in ("wi", "f", "pdf", "specular", "transmission"):
        assert torch.equal(got[key], want[key]), key
    assert (got["pdf"] > 0).float().mean() > 0.5
    if kind == ss.GLASS:
        assert 0.3 < got["transmission"].float().mean() < 0.9


# --------------------------------------------------------- the scene file
def test_xml_loads_to_the_stated_material_rows():
    """The port's importer reads the spheres' parameters by name and
    drops names it does not know: the rows it makes are the ones the
    configuration states, and the reference's reader makes the same
    triangles and materials."""
    _, sd, settings = load_mitsuba(SCENE, resolution=(32, 24), device="cpu")
    assert sd.p0.shape[0] == 552 and int(sd.n_lights) == 2
    assert not (sd.tri_alpha_txd >= 0).any()
    assert settings["spp"] == 64 and settings["max_depth"] == 65
    mt = sd.mat_type.numpy()
    used = sorted(set(np.unique(sd.material_id.numpy()).tolist()))
    assert sorted(set(mt[used].tolist())) == [MAT_MATTE, MAT_GLASS,
                                              MAT_METAL, MAT_SUBSTRATE]
    attr = pack_mat_attr(sd)
    rows = {int(t): attr[list(mt).index(t)] for t in
            (MAT_METAL, MAT_SUBSTRATE, MAT_GLASS)}
    metal, sub, glass = (rows[t] for t in (MAT_METAL, MAT_SUBSTRATE,
                                           MAT_GLASS))
    np.testing.assert_array_equal(metal[MA_ETA],
                                  np.float32([0.2, 0.92, 1.1]))
    np.testing.assert_array_equal(metal[MA_K],
                                  np.float32([3.9, 2.45, 2.14]))
    np.testing.assert_array_equal(metal[MA_ROUGH][:2],
                                  np.float32([0.1, 0.1]))
    np.testing.assert_array_equal(sub[MA_KD],
                                  np.float32([0.4, 0.2, 0.55]))
    np.testing.assert_allclose(sub[MA_KS], 0.04, rtol=1e-6)
    np.testing.assert_array_equal(sub[MA_ROUGH][:2],
                                  np.float32([0.05, 0.05]))
    np.testing.assert_array_equal(glass[MA_ETA], np.float32([1.5] * 3))

    tris = ss.load(SCENE)
    for i, p in enumerate((sd.p0, sd.p1, sd.p2)):
        np.testing.assert_array_equal(tris["p"][:, i], p.numpy())
    kinds = {MAT_MATTE: ss.MATTE, MAT_METAL: ss.METAL,
             MAT_SUBSTRATE: ss.SUBSTRATE, MAT_GLASS: ss.GLASS}
    want = np.array([kinds[int(t)] for t in mt[sd.material_id.numpy()]])
    np.testing.assert_array_equal(tris["mtype"], want)
    assert tris["light_tri"].tolist() == np.flatnonzero(
        sd.area_light_id.numpy() >= 0).tolist()


def test_sphere_mesh_is_upstreams_uv_sphere():
    """180 triangles a sphere, every edge shared by two of them (the
    mesh is closed, as glass needs), the normals the unit directions."""
    pos, nrm, tri = ss.sphere([0.5, 0.35, -0.3], 0.35)
    assert tri.shape == (180, 3) and pos.dtype == np.float32
    edges = {}
    for a, b, c in tri.tolist():
        for e in ((a, b), (b, c), (c, a)):
            key = tuple(sorted(map(tuple, pos[list(e)].round(6).tolist())))
            edges[key] = edges.get(key, 0) + 1
    assert set(edges.values()) == {2}
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(pos, np.float32([0.5, 0.35, -0.3])
                               + np.float32(0.35) * nrm, atol=1e-7)


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
    assert prog.scene.use_bvh
    film = prog.integ.render(prog.camera(view), prog.scene)
    ref = sp.render_tiles(cfg, traffic, view, tiles, 4, "cpu")
    numbers = check.compare(check.read_tiles(film, tiles, 8),
                            check.read_tiles(ref, tiles, 8))
    correct, compared = check.judge(numbers, limits)
    assert correct, compared
    assert float(ref[..., :3].sum()) > 0


# ------------------------------------------------------------ the counter
@pytest.fixture(scope="module")
def spheres():
    cam, sd, _ = load_mitsuba(SCENE, resolution=(16, 12), device="cpu")
    return cam, TracedScene.create(sd)


def test_live_lane_counter_counts_the_active_lanes(spheres):
    """``trace_wave``'s count equals ``count_nonzero`` of the active
    lanes at each bounce's start, on the eager path; a render's count
    changes no film bit, and ``lane_bounces`` sums it beside every lane
    of every band-frame at every bounce."""
    cam, scene = spheres
    cfg = PathConfig(max_depth=15, mis_mode="onesample")
    n = 2048
    g = torch.Generator().manual_seed(3)
    o = torch.tensor([[0.0, 1.0, 3.0]]).repeat(n, 1)
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.0, -1.0]) + 0.35 * (torch.rand(n, 3, generator=g)
                                                 - 0.5), dim=-1)
    us = torch.rand(64, n, generator=g)

    def draw(dim):
        return us[dim % 64]

    def draw2(dim):
        return torch.stack([draw(dim), draw(dim + 1)], -1)

    occ = torch.zeros(16, dtype=torch.float64)
    radiance, rays, _ = trace_wave(scene, cfg, draw, draw2, o, d,
                                   occupancy=occ)
    st = pint._wave_init(scene, cfg, o, d)
    want = []
    for bounce in range(16):
        want.append(int(torch.count_nonzero(st["active"])))
        st = pint._wave_bounce(scene, cfg, bounce, st, draw, draw2)
    assert occ.tolist() == want
    assert want[0] == n and want[-1] < want[1] and want[-1] > 0
    assert torch.equal(radiance, pint._wave_radiance(cfg, st)[0])

    plain = PathIntegrator(cfg, spp=2)
    counted = PathIntegrator(cfg, spp=2)
    inner = plain.render_frames
    plain.render_frames = lambda su, film_pad, band, s0, n_frames, occ: \
        inner(su, film_pad, band, s0, n_frames, None)
    assert torch.equal(plain.render(cam, scene), counted.render(cam, scene))
    lanes = 20 * 16 * 2  # the 20 x 16 sample rectangle, two frames
    assert counted.bounce_occupancy[0] == lanes
    assert counted.lane_bounces == dict(
        live=float(counted.bounce_occupancy.sum()), run=lanes * 16.0)
    assert plain.bounce_occupancy.tolist() == [0.0] * 16


# ------------------------------------------------------ K2's byte count
def test_k2_bytes_count_as_launches_do(monkeypatch):
    """K2's bytes a launch: rays read once (28 B), hits written once
    (21 B, or 1 B any-hit), the table read once (1 KiB a row); counted in
    ``bvhw_cu.BYTES`` through ``_build.count``, tallied while a graph is
    captured and added once a replay."""
    assert bvhw_cu.launch_bytes(35, 131072, False) == \
        131072 * 49 + 35 * 1024
    assert bvhw_cu.launch_bytes(35, 1000, True) == 1000 * 29 + 35 * 1024
    monkeypatch.setattr(bvhw_cu, "BYTES", 0)
    _build.count("bvhw.bytes", 100)
    assert bvhw_cu.BYTES == 100
    with _build.capturing() as tally:
        _build.count("bvhw.bytes", 7)
        _build.count("bvhw.bytes", 5)
    assert tally == {"bvhw.bytes": 12} and bvhw_cu.BYTES == 100
    for _ in range(3):
        _build.replayed(tally)
    assert bvhw_cu.BYTES == 136


# --------------------------------------------------------- the reference
def test_reference_imports_neither_package():
    """``sphere_path`` and its scene reader import nothing of
    ``pathtracer_tpu`` or ``pathtracer_tpu_torch``, in their source and
    when imported alone."""
    for name in ("sphere_path.py", "sphere_scene.py"):
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
            "import reference.sphere_path; import json; "
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
    integrator: (films, counts, GRAPH_COUNTS moved, K2 launches and
    bytes moved)."""
    cam, sd, _ = load_mitsuba(SCENE, resolution=(160, 120), device=dev)
    scene = TracedScene.create(sd)
    integ = PathIntegrator(PathConfig(max_depth=15, mis_mode="onesample"),
                           spp=8, band_rows=40)
    real = pint._graph_engages
    if not engage:
        pint._graph_engages = lambda scene, cfg: False
    before = dict(pint.GRAPH_COUNTS)
    k2 = (bvhw_cu.LAUNCHES, bvhw_cu.BYTES)
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
                lanes=dict(integ.lane_bounces),
                k2=(bvhw_cu.LAUNCHES - k2[0], bvhw_cu.BYTES - k2[1]))


@pytest.mark.cuda
def test_graph_films_equal_eager_on_the_spheres(dev):
    """Graph replay against eager on the new scene (K2, four BSDF
    branches, 16 bounces), with the spans and the live-lane count in
    place: films and counts equal, K2's launches and bytes alike."""
    g, e = _render_two(dev, True), _render_two(dev, False)
    assert g["moved"]["replays"] > 0 and e["moved"]["replays"] == 0
    for got, want in zip(g["films"], e["films"]):
        assert torch.isfinite(got).all() and (got[..., 3] > 0).all()
        assert torch.equal(got, want)
    for got, want in zip(g["occ"], e["occ"]):
        np.testing.assert_array_equal(got, want)
    assert g["lanes"] == e["lanes"] and g["k2"] == e["k2"]
    assert g["k2"][0] > 0 and g["k2"][1] > 0


@pytest.mark.cuda
def test_every_k2_kernel_of_a_traced_replay_links_to_its_span(dev):
    """Under the profiler a replay runs the cut form: each K2 kernel
    links, by its graph launch's correlation id, to a ``pt::k:bvhw``
    span, as many as the replays' counted launches; the BSDF spans hold
    device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cam, sd, _ = load_mitsuba(SCENE, resolution=(64, 48), device=dev)
    scene = TracedScene.create(sd)
    integ = PathIntegrator(PathConfig(max_depth=15, mis_mode="onesample"),
                           spp=2)
    integ.render(cam, scene)  # captures
    torch.cuda.synchronize()
    launches = bvhw_cu.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        integ.render(cam, scene)
        torch.cuda.synchronize()
    launches = bvhw_cu.LAUNCHES - launches
    spans, runtime, k2, bsdf = [], {}, [], 0
    events = list(prof.profiler.kineto_results.events())
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("pt::"):
                spans.append((e.name(), e.start_ns(), e.end_ns()))
            elif e.name().startswith("cu"):
                runtime[e.correlation_id()] = (e.name(), e.start_ns())
    for e in events:
        if e.device_type() != DeviceType.CPU and not e.is_user_annotation():
            name, t = runtime.get(e.correlation_id(), (None, None))
            held = [n for n, s, x in spans if t is not None and s <= t <= x]
            if "bvhw_kernel" in e.name():
                k2.append((name, held))
            bsdf += any(n.startswith("pt::bsdf:") for n in held)
    assert len(k2) == launches > 0
    for name, held in k2:
        assert name.startswith("cudaGraphLaunch"), name
        assert held[-1] == "pt::k:bvhw", held
    assert bsdf > 0
