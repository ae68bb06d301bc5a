"""The port stands alone: it imports neither JAX nor the JAX package, reads
no file of it, and runs from a copy of its own directory.

Its copies of the JAX package's data (the Sobol tables, the native BVH
builder's source) must stay byte-equal to the originals, and its entry
points build on the card unless the caller asks for the CPU.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import pathtracer_tpu_torch
from pathtracer_tpu_torch.accel import cpp
from pathtracer_tpu_torch.ops import sobol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.dirname(os.path.abspath(pathtracer_tpu_torch.__file__))
JAX_PKG = os.path.join(ROOT, "pathtracer_tpu")


def _modules():
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d not in ("build",
                                                         "__pycache__")]
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    paths = list(_modules())
    assert len(paths) > 20
    bad = [(os.path.relpath(p, ROOT), name) for p in paths
           for name in _imported(p)
           if name.split(".")[0] in ("jax", "jaxlib", "pathtracer_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench_torch.py",
                                    "kernel_ab.py", "host_steps.py",
                                    "k1_variants.py", "k2_variants.py",
                                    "probe_variants.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts run on the card, where JAX is absent, import neither
    JAX nor the JAX package."""
    bad = [name for name in _imported(os.path.join(ROOT, script))
           if name.split(".")[0] in ("jax", "jaxlib", "pathtracer_tpu")]
    assert not bad, bad


def test_no_module_names_a_jax_package_path():
    """No code path reaches into pathtracer_tpu/ (docstrings may name the
    reference; string constants that build paths may not)."""
    for path in _modules():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert node.value != "pathtracer_tpu", path


_BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pathtracer_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.procedural import box_field_scene
cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=(8, 8),
                          device="cpu")
film = PathIntegrator(PathConfig(max_depth=2), spp=1).render(cam, sd)
assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
cam, sd = box_field_scene((8, 6), n_boxes=30, device="cpu")
assert sd.p0.shape[0] > 128
film = PathIntegrator(PathConfig(max_depth=2), spp=1).render(cam, sd)
assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
from pathtracer_tpu_torch.scene.gltf import load_gltf
cam, sd, _ = load_gltf("data/classroom_proc.glb", resolution=(8, 6),
                       device="cpu")
film = PathIntegrator(PathConfig(max_depth=1), spp=1).render(cam, sd)
assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
# the alpha path: Sponza's split (its foliage's own table, re-spawns)
# and a checkpoint saved and resumed
from pathtracer_tpu_torch import integrator
cam, sd, _ = load_gltf("data/sponza_proc.glb", resolution=(8, 6),
                       device="cpu")
integ = PathIntegrator(PathConfig(max_depth=1), spp=2)
film = integ.render_progressive(cam, sd, chunk_spp=1, checkpoint="ck")
assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
assert integrator.RETRY_COUNTS["alpha_tree"] > 0
again = PathIntegrator(PathConfig(max_depth=1), spp=2)
assert torch.equal(again.render_progressive(cam, sd, chunk_spp=1,
                                            checkpoint="ck"), film)
assert again.last_ray_count == 0.0
# the other samplers, all lights, the light tracer and the rest of the
# Mitsuba importer (a sphere, a dielectric, a plastic, the sunsky map)
from pathtracer_tpu_torch.integrator_lt import LightTracer
cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=(8, 8),
                          device="cpu")
for cfg in (PathConfig(max_depth=2, sampler="stratified",
                       light_strategy="all"),
            PathConfig(max_depth=2, sampler="random")):
    film = PathIntegrator(cfg, spp=2).render(cam, sd)
    assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
film = LightTracer(PathConfig(max_depth=2), paths=4096,
                   wave=2048).render(cam, sd)
assert torch.isfinite(film).all() and film[..., :3].sum() > 0
with open("data/cornell-box.xml") as fh:
    xml = fh.read().replace("</scene>", '''
  <bsdf type="dielectric" id="G"/><bsdf type="plastic" id="P"/>
  <shape type="sphere"><float name="radius" value="0.3"/><ref id="G"/>
  </shape>
  <shape type="cube"><ref id="P"/></shape>
  <emitter type="sunsky"/></scene>''')
with open("features.xml", "w") as fh:
    fh.write(xml)
cam, sd, _ = load_mitsuba("features.xml", resolution=(8, 8), device="cpu")
assert bool(sd.has_env) and sd.p0.shape[0] == 36 + 180 + 12
film = PathIntegrator(PathConfig(max_depth=2), spp=1).render(cam, sd)
assert torch.isfinite(film).all() and (film[..., 3] > 0).all()
# the frontends: the CLI's headless render (and its occupancy counts),
# a single-pixel trace, the viewer's preview and two gloo ranks
from pathtracer_tpu_torch.frontend import cli
from pathtracer_tpu_torch.frontend.debug import render_single_pixel
from pathtracer_tpu_torch.frontend.interactive import preview_frame
assert cli.main(["data/cornell-box.xml", "-o", "cli.png", "-r", "8x8",
                 "-d", "2", "--device", "cpu", "--profile", "prof"]) == 0
assert cli.main(["data/cornell-box.xml", "-o", "mesh.png", "-r", "8x8",
                 "-d", "2", "--device", "cpu", "--mesh", "2"]) == 0
import os
assert os.path.isfile("cli.png") and os.path.isfile("mesh.png")
assert os.path.isfile("prof/trace.json")
cam, sd, _ = load_mitsuba("data/cornell-box.xml", resolution=(8, 8),
                          device="cpu")
rad = render_single_pixel(cam, sd, PathConfig(max_depth=2), (4, 4), 2)
assert rad.shape == (2, 3) and torch.isfinite(rad).all()
assert preview_frame(cam, sd).shape == (8, 8, 3)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "pathtracer_tpu")]
# Pillow is imported only to read a JPEG, which no asset holds
assert "PIL" not in sys.modules
print("ok")
"""


def test_copy_of_the_port_renders_without_the_jax_package(tmp_path):
    shutil.copytree(PORT, tmp_path / "pathtracer_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    os.makedirs(tmp_path / "data")
    for name in ("cornell-box.xml", "classroom_proc.glb",
                 "sponza_proc.glb", "abandoned_tank_farm_04_1k.hdr"):
        shutil.copy(os.path.join(ROOT, "data", name), tmp_path / "data")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["sobol_32.npy", "sobol_vdc.npy",
                                  "sobol_vdc_inv.npy", "bvh_builder.cpp"])
def test_copies_lie_in_the_port_and_equal_the_originals(name):
    if name.endswith(".cpp"):
        path, orig = cpp.SOURCE, os.path.join(JAX_PKG, "accel", "cpp", name)
        assert os.path.basename(path) == name
    else:
        path = os.path.join(sobol._ASSET_DIR, name)
        orig = os.path.join(JAX_PKG, "assets", name)
    path = os.path.realpath(path)
    assert path.startswith(PORT + os.sep), path
    with open(path, "rb") as a, open(orig, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("module", ["frontend/tev.py", "core/controller.py",
                                    "utils/logging.py"])
def test_copied_modules_equal_the_originals(module):
    """The tev wire protocol, the camera controllers and the loggers are
    host code that the port keeps byte for byte (the controllers' one
    import is relative: the port's own Camera)."""
    path = os.path.join(PORT, module)
    with open(path, "rb") as a, \
            open(os.path.join(JAX_PKG, module), "rb") as b:
        assert a.read() == b.read()


def test_every_module_of_the_jax_package_has_its_counterpart():
    """The port has a module for each of the JAX package's (three under
    another name), but those left out for good as TPU workarounds
    (ROADMAP, "Left out for good": the tuning knobs, the wavefront sort,
    the one-hot MXU gather)."""
    left_out = {"tuning.py", "ops/sort.py", "ops/gather.py"}
    renamed = {"accel/cpp/__init__.py": "accel/cpp.py",
               "ops/pallas/__init__.py": "ops/cuda/__init__.py",
               "ops/pallas/intersect_pl.py": "ops/cuda/intersect_cu.py"}
    missing = []
    for dirpath, dirnames, filenames in os.walk(JAX_PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            rel = os.path.relpath(os.path.join(dirpath, name), JAX_PKG)
            if name.endswith(".py") and rel not in left_out and \
                    not os.path.isfile(os.path.join(
                        PORT, renamed.get(rel, rel))):
                missing.append(rel)
    assert not missing, missing
    for module in ("parallel/mesh.py", "frontend/cli.py",
                   "frontend/headless.py", "frontend/debug.py",
                   "frontend/interactive.py", "frontend/tev.py",
                   "core/controller.py"):
        assert os.path.isfile(os.path.join(PORT, module)), module


@pytest.mark.parametrize("module", ["utils/logging.py", "utils/image.py",
                                    "scene/texture.py", "scene/gltf.py"])
def test_copied_modules_lie_in_the_port_and_import_torch_or_numpy(module):
    """The port's own copies of the JAX package's host modules (the
    loggers, the image decoders, the texture pool and the glTF importer)
    lie in the port and import only the standard library, numpy, torch
    and the port; Pillow only inside ``read_jpeg``."""
    path = os.path.join(PORT, module)
    assert os.path.isfile(path)
    assert os.path.isfile(os.path.join(JAX_PKG, module))
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module.split(".")[0])
    allowed = {"__future__", "base64", "dataclasses", "json", "logging",
               "os", "struct", "zlib", "numpy", "torch"}
    assert top <= allowed, top - allowed
    imports = {name.split(".")[0] for name in _imported(path)}
    assert ("PIL" in imports) == (module == "utils/image.py")


def test_default_device_is_the_card():
    """Without a CUDA card, a call that does not ask for the CPU raises
    rather than quietly building CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default call succeeds")
    from pathtracer_tpu_torch.scene.gltf import load_gltf
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
    with pytest.raises((AssertionError, RuntimeError)):
        load_mitsuba(os.path.join(ROOT, "data", "cornell-box.xml"),
                     resolution=(8, 8))
    with pytest.raises((AssertionError, RuntimeError)):
        load_gltf(os.path.join(ROOT, "data", "classroom_proc.glb"),
                  resolution=(8, 8))
