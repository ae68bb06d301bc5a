"""The ``sphereflake`` configuration: Eric Haines's SPD sphereflake as a
glTF file of one instanced UV-sphere mesh, a floor and three point lights
(``benchmark/scenes/sphereflake.gltf``, written by
``benchmark/scenes/make_sphereflake.py``), on the port's normal path
(``load_gltf``, ``TracedScene.create``, the bounce loop) against the
benchmark's plain reference (``benchmark/reference/flake_path.py`` with
its reader ``flake_scene.py``), and the span and counters its cell reads:
``pt::light``, ``bvhw_cu.RAYS`` and ``integrator.TABLES_S``.

The full flake (7,381 spheres, 1,328,582 triangles) is counted from the
file's JSON alone; the renders here use the generator's size factors 1
and 2 (10 and 91 spheres). The reference takes the Disney BSDF's products
as the port does, so its BSDF is held to the port's bit for bit, and its
films to the port's under the cell's own limits.

The test marked ``cuda`` needs a card (it skips without one): K2's lane
count, launch by launch and under graph replay. The file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_sphereflake.py
"""

import ast
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
from pathtracer_tpu_torch.ops.cuda import _build, bvhw_cu
from pathtracer_tpu_torch.scene.gltf import load_gltf
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.scene import (LIGHT_POINT, MA_ETA, MA_KD,
                                              MA_MISC, MAT_DISNEY,
                                              pack_mat_attr)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SCENE = os.path.join(BENCH, "scenes", "sphereflake.gltf")
CONFIG = os.path.join(BENCH, "configs", "sphereflake.json")
CORNELL = os.path.join(ROOT, "data", "cornell-box.xml")
CELL = "sphereflake-640-d15"
for path in (BENCH, os.path.join(BENCH, "scenes")):
    if path not in sys.path:
        sys.path.insert(0, path)

import make_sphereflake as msf  # noqa: E402
from reference import flake_path as fp  # noqa: E402
from reference import flake_scene as fs  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The generator's flakes at size factors 1 and 2: {factor: path}."""
    folder = tmp_path_factory.mktemp("flakes")
    return {k: msf.write(str(folder / f"sf{k}.gltf"), k) for k in (1, 2)}


def _config(path=None) -> dict:
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    cfg["scene"]["path"] = path or os.path.join(
        os.path.dirname(CONFIG), cfg["scene"]["file"])
    return cfg


# ------------------------------------------------------------- the file
def test_generator_reproduces_the_committed_file():
    """The generator at size factor 4 writes the committed file, whose
    hash the configuration names; its JSON holds 7,381 nodes of the
    sphere mesh (180 triangles) and one of the floor (2): 1,328,582
    triangles, and three point lights, as the configuration states."""
    import hashlib

    with open(SCENE) as fh:
        text = fh.read()
    assert json.dumps(msf.gltf(4), separators=(",", ":")) + "\n" == text
    cfg = _config()
    assert hashlib.sha256(text.encode()).hexdigest() == cfg["scene"]["sha256"]
    doc = json.loads(text)
    tris = [doc["accessors"][m["primitives"][0]["indices"]]["count"] // 3
            for m in doc["meshes"]]
    assert tris == [180, 2]
    meshes = [n["mesh"] for n in doc["nodes"] if "mesh" in n]
    assert meshes.count(0) == cfg["spheres"] == 7381 == sum(
        9 ** k for k in range(5))
    assert meshes.count(1) == 1
    assert sum(tris[m] for m in meshes) == cfg["triangles"] == 1328582
    lights = [n for n in doc["nodes"]
              if "KHR_lights_punctual" in n.get("extensions", {})]
    kinds = doc["extensions"]["KHR_lights_punctual"]["lights"]
    assert len(lights) == cfg["lights"] == 3
    assert [k["type"] for k in kinds] == ["point"] * 3
    assert [n["translation"] for n in lights] == [list(p)
                                                  for p in msf.LIGHTS]
    assert cfg["alpha_masked_triangles"] == 0 and cfg["reduced"] == []
    cam = [n for n in doc["nodes"] if "camera" in n][0]
    np.testing.assert_array_equal(
        np.asarray(cam["matrix"]).reshape(4, 4).T,
        np.asarray(cfg["camera"]["cam_to_world"]))
    # the box: the floor's square in x and y, from the floor to the top
    # pole of the highest sphere in z
    top = max(n["translation"][2] + n["scale"][2] for n in doc["nodes"]
              if n.get("mesh") == 0)
    diag = np.linalg.norm([12.0, 12.0, top + 0.5])
    assert abs(cfg["bbox_diagonal"] - diag) < 1e-5


def test_flake_is_spds_recursion():
    """Nine children a sphere, a third its radius, tangent to it: six on
    its equator (about the direction it grew in), three above it; no two
    spheres overlap."""
    kids = msf.child_directions()
    np.testing.assert_allclose(np.linalg.norm(kids, axis=1), 1.0)
    z = np.sort(kids[:, 2])
    np.testing.assert_allclose(z[:6], 0.0, atol=1e-12)
    np.testing.assert_allclose(z[6:], np.sqrt(2.0 / 3.0))
    spheres = msf.flake(2)
    assert len(spheres) == 91 and spheres[0][1] == 0.5
    c = np.array([s[0] for s in spheres])
    r = np.array([s[1] for s in spheres])
    gap = np.linalg.norm(c[:, None] - c[None], axis=-1) - (r[:, None]
                                                           + r[None])
    np.fill_diagonal(gap, np.inf)
    assert gap.min() > -1e-12
    assert int((np.abs(gap) < 1e-12).sum()) // 2 == 90  # parent and child
    assert (c[:, 2] - r).min() == pytest.approx(-0.5)


def test_gltf_loads_to_the_readers_triangles(small):
    """The port's importer and the reference's reader place every
    triangle, normal and light alike, bit for bit, and the port makes
    every surface Disney with the file's factors."""
    _, sd, _ = load_gltf(small[2], resolution=(16, 12), device="cpu")
    tris = fs.load(small[2])
    assert sd.p0.shape[0] == len(tris["p"]) == 91 * 180 + 2
    for i, key in enumerate(("p0", "p1", "p2")):
        assert np.array_equal(getattr(sd, key).numpy(), tris["p"][:, i])
    for i, key in enumerate(("n0", "n1", "n2")):
        assert np.array_equal(getattr(sd, key).numpy(), tris["n"][:, i])
    assert sd.light_type.tolist() == [LIGHT_POINT] * 3
    assert np.array_equal(sd.light_vec.numpy(), tris["light_p"])
    assert np.array_equal(sd.light_emit.numpy(), tris["light_i"])
    rows = pack_mat_attr(sd)[sd.material_id.numpy()]
    assert set(sd.mat_type.numpy()[sd.material_id.numpy()]) == {MAT_DISNEY}
    assert np.array_equal(rows[:, MA_KD], tris["kd"])
    assert np.array_equal(rows[:, MA_MISC][:, 0], tris["metallic"])
    assert np.array_equal(rows[:, MA_MISC][:, 1], tris["roughness"])
    assert np.array_equal(rows[:, MA_ETA][:, 0], tris["eta"])
    scene = TracedScene.create(sd)
    assert scene.use_bvh and scene.mat_set == (MAT_DISNEY,)
    assert scene.light_set == (LIGHT_POINT,) and scene.n_lights == 3


# ------------------------------------------------------------ the BSDF
def test_disney_equals_the_reference_bit_for_bit():
    """The port's Disney f, pdf and sample against the reference's, on
    seeded random directions entering and leaving, samples, base colours,
    metallic and roughness in [0, 1], with a geometric normal that
    disagrees with the shading frame on some lanes. Tolerance: none: both
    compute in float32 with the same products in the same order and a
    correctly rounded root, and a bit of beta can move the roulette."""
    n = 4096
    g = np.random.default_rng(27)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def unit():
        v = g.normal(size=(n, 3))
        return t(v / np.linalg.norm(v, axis=1, keepdims=True))

    wo, wi = unit(), unit()
    u = t(g.uniform(0.0, 1.0, (n, 2)))
    kd = t(g.uniform(0.0, 1.0, (n, 3)))
    metallic = t(g.uniform(0.0, 1.0, n))
    rough = t(g.uniform(0.0, 1.0, n))
    alpha = torch.clamp_min(rough * rough, 0.001)
    eta = t(np.full(n, 1.5))
    mp = dict(mtype=torch.full((n,), MAT_DISNEY, dtype=torch.int32), kd=kd,
              ks=torch.zeros(n, 3), eta3=eta[:, None].expand(n, 3), eta=eta,
              k=torch.zeros(n, 3), ax=alpha, ay=alpha, metallic=metallic)
    row = dict(kd=kd, metallic=metallic, eta=eta, alpha=alpha)
    reflect = t(g.uniform(-1.0, 1.0, n)) > -0.2
    f, pdf = bx.eval_f_pdf(mp, wo, wi, reflect, present=(MAT_DISNEY,))
    f_ref, pdf_ref = fp.eval_f_pdf(row, wo, wi, reflect)
    assert torch.equal(f, f_ref) and torch.equal(pdf, pdf_ref)
    assert (pdf > 0).float().mean() > 0.3 and (f > 0).any()

    def ng_test(w):
        return w[:, 0] + 0.3 * w[:, 2] > -0.1

    got = bx.sample_f(mp, wo, u, ng_test, present=(MAT_DISNEY,))
    want = fp.sample_f(row, wo, u, ng_test)
    for key in ("wi", "f", "pdf"):
        assert torch.equal(got[key], want[key]), key
    assert not got["specular"].any() and not got["transmission"].any()
    assert (got["pdf"] > 0).float().mean() > 0.5


# ---------------------------------------------------- the intersection
def test_two_level_intersection_equals_the_brute_force(small):
    """The reference's two-level intersection (instance spheres, then
    their triangles) against its own test of every triangle, on seeded
    rays through the size-factor-2 flake: closest hits (triangle,
    barycentrics) and shadow queries equal."""
    scene = fp.Scene(fs.load(small[2]), "cpu")
    g = np.random.default_rng(2026)
    n = 2000
    o = g.uniform(-1.5, 1.5, (n, 3))
    o[:, 2] = np.abs(o[:, 2])
    d = g.uniform(-0.8, 0.8, (n, 3)) - o
    o = torch.as_tensor(o.astype(np.float32))
    d = torch.as_tensor((d / np.linalg.norm(d, axis=1, keepdims=True))
                        .astype(np.float32))
    got, want = scene.closest(o, d), fp.dp.Scene.closest(scene, o, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0.5 < float(got[0].float().mean()) < 1.0
    t_max = torch.as_tensor(g.uniform(0.2, 3.0, n).astype(np.float32))
    brute = torch.zeros(n, dtype=torch.bool)
    for lo in range(0, scene.p0.shape[0], 64):
        sl = slice(lo, lo + 64)
        brute |= fp.dp.watertight(o[:, None], d[:, None], t_max[:, None],
                                  scene.p0[sl], scene.p1[sl],
                                  scene.p2[sl])[2].any(dim=1)
    occ = scene.occluded(o, d, t_max)
    assert torch.equal(occ, brute) and 0 < int(occ.sum()) < n


# ------------------------------------------------------------ the film
@pytest.mark.parametrize("factor, seed", [(1, 3000000001),
                                          (2, 2 ** 31 + 27)],
                         ids=["sf1", "sf2"])
def test_film_matches_the_reference_under_the_cells_limits(small, factor,
                                                           seed):
    """The port's film of a seeded view at 32 x 24, 4 spp, depth 15
    (K2's plain traversal here) against the reference's at the seed's
    check tiles, under the cell's three limits."""
    from harness import check, manifest, workload
    from harness.program import Program

    cfg = _config(small[factor])
    man = manifest.load_manifest()
    entry = manifest.cell(man, CELL)
    traffic = dict(manifest.traffic(entry["traffic"]), resolution=[32, 24],
                   job_spp=4, pass_spp=4, check=dict(tiles=4, tile_px=8))
    assert traffic["max_depth"] == 15
    view = workload.moved_camera(cfg, traffic, seed)
    tiles = workload.check_tiles(seed, traffic)
    prog = Program(cfg, traffic, "cpu")
    assert prog.scene.use_bvh and prog.scene.mat_set == (MAT_DISNEY,)
    film = prog.integ.render(prog.camera(view), prog.scene)
    ref = fp.render_tiles(cfg, traffic, view, tiles, 4, "cpu")
    numbers = check.compare(check.read_tiles(film, tiles, 8),
                            check.read_tiles(ref, tiles, 8))
    correct, compared = check.judge(numbers, manifest.limits(CELL))
    assert correct, compared
    assert float(ref[..., :3].sum()) > 0


# ----------------------------------------------------- span and counters
def _light_calls(monkeypatch):
    """Count the calls of ``sample_li`` and ``pdf_li``."""
    calls = dict(n=0)
    for name in ("sample_li", "pdf_li"):
        fn = getattr(lt, name)

        def spy(*args, _fn=fn, **kw):
            calls["n"] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(lt, name, spy)
    return calls


@pytest.mark.parametrize("which", ["flake", "cornell"])
def test_light_calls_run_in_the_light_span(small, monkeypatch, which):
    """A profiled render opens one ``pt::light`` a call of ``sample_li``
    or ``pdf_li``: in the flake the light sample of each shading bounce
    (in ``pt::nee``), in cornell also the area light's density along the
    rays that hit it (in ``pt::shade``); each span holds the call's
    operations."""
    from torch.autograd import DeviceType

    if which == "flake":
        cam, sd, _ = load_gltf(small[1], resolution=(8, 6), device="cpu")
    else:
        cam, sd, _ = load_mitsuba(CORNELL, resolution=(8, 6), device="cpu")
    calls = _light_calls(monkeypatch)
    integ = PathIntegrator(PathConfig(max_depth=3, mis_mode="onesample"),
                           spp=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        integ.render(cam, sd)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in events
             if e.name().startswith("pt::")]
    light = [s for s in spans if s[0] == "pt::light"]
    frames = sum(s[0] == "pt::band_frame" for s in spans)
    # three shading bounces a band-frame; cornell's shade takes the
    # density at bounces 1 to 3
    per_frame = 3 if which == "flake" else 6
    assert len(light) == calls["n"] == per_frame * frames > 0
    ops = [(e.start_ns(), e.end_ns()) for e in events
           if e.name().startswith("aten::")]
    for _, lo, hi in light:
        assert any(lo <= s and e <= hi for s, e in ops)
        around = {n for n, s, e in spans if s <= lo and hi <= e}
        assert around & {"pt::nee", "pt::shade"}


def test_create_counts_its_seconds(small):
    """``TracedScene.create`` adds its seconds to ``TABLES_S``, on the BVH
    route (the flake) and on the brute-force route (cornell)."""
    _, flake, _ = load_gltf(small[1], resolution=(8, 6), device="cpu")
    _, cornell, _ = load_mitsuba(CORNELL, resolution=(8, 6), device="cpu")
    for sd, bvh in ((flake, True), (cornell, False)):
        before = pint.TABLES_S
        scene = TracedScene.create(sd)
        assert scene.use_bvh == bvh
        assert pint.TABLES_S > before


def test_k2_rays_count_as_launches_do(monkeypatch):
    """K2's lanes a launch, counted in ``bvhw_cu.RAYS`` through
    ``_build.count``, tallied while a graph is captured and added once a
    replay, as its bytes are."""
    monkeypatch.setattr(bvhw_cu, "RAYS", 0)
    _build.count("bvhw.rays", 131072)
    assert bvhw_cu.RAYS == 131072
    with _build.capturing() as tally:
        _build.count("bvhw.rays", 7)
        _build.count("bvhw.rays", 5)
    assert tally == {"bvhw.rays": 12} and bvhw_cu.RAYS == 131072
    for _ in range(3):
        _build.replayed(tally)
    assert bvhw_cu.RAYS == 131072 + 36


# --------------------------------------------------------- the reference
def test_reference_imports_neither_package():
    """``flake_path`` and its reader import nothing of ``pathtracer_tpu``
    or ``pathtracer_tpu_torch``, in their source and when imported
    alone."""
    for name in ("flake_path.py", "flake_scene.py"):
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
            "import reference.flake_path; import json; "
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
        pytest.skip("needs a CUDA card: K2 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k2_rays_grow_by_each_launchs_lanes(dev, small):
    """On the card each K2 launch adds its lanes to ``bvhw_cu.RAYS`` (and
    one to ``LAUNCHES``), closest-hit and any-hit alike, and a graph's
    replay adds its capture's lanes."""
    _, sd, _ = load_gltf(small[2], resolution=(8, 6), device=dev)
    scene = TracedScene.create(sd)
    g = torch.Generator().manual_seed(3)
    n = 5000
    o = (torch.rand(n, 3, generator=g) * 3.0 - 1.5).to(dev)
    d = torch.nn.functional.normalize(torch.rand(n, 3, generator=g) - 0.5,
                                      dim=1).to(dev)
    t_max = torch.full((n,), float("inf"), device=dev)
    rays, launches = bvhw_cu.RAYS, bvhw_cu.LAUNCHES
    bvhw_cu.bvhw_intersect(scene.bw_rows, o, d, t_max,
                           stackw=scene.bw_depth)
    bvhw_cu.bvhw_intersect(scene.bw_rows, o[:300], d[:300], t_max[:300],
                           any_hit=True, stackw=scene.bw_depth)
    torch.cuda.synchronize()
    assert bvhw_cu.RAYS - rays == n + 300
    assert bvhw_cu.LAUNCHES - launches == 2
    stream = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):  # warm-up off the default stream
        bvhw_cu.bvhw_intersect(scene.bw_rows, o, d, t_max,
                               stackw=scene.bw_depth)
    torch.cuda.synchronize()
    with _build.capturing() as tally, torch.cuda.graph(graph):
        bvhw_cu.bvhw_intersect(scene.bw_rows, o, d, t_max,
                               stackw=scene.bw_depth)
    assert tally["bvhw.rays"] == n
    rays = bvhw_cu.RAYS
    for _ in range(2):
        graph.replay()
        _build.replayed(tally)
    torch.cuda.synchronize()
    assert bvhw_cu.RAYS - rays == 2 * n
