"""Nothing under benchmark/ imports JAX or the JAX package, and nothing
under benchmark/reference/ imports the port: each import's top-level
name compared whole (``pathtracer_tpu_torch`` is not ``pathtracer_tpu``)."""

import ast
import os

import pytest

from conftest import BENCH_DIR

JAX_NAMES = {"jax", "jaxlib", "flax", "pathtracer_tpu"}
PORT = "pathtracer_tpu_torch"
# what the plain reference may import: numpy, torch and the standard
# library's parts it uses
REFERENCE_MAY = {"__future__", "numpy", "torch", "os", "xml"}


def _sources(sub=""):
    root = os.path.join(BENCH_DIR, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    """Top-level names of the absolute imports in ``path``, and the
    ``importlib.import_module`` / ``__import__`` calls with a constant."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and (
                    getattr(node.func, "attr", None) == "import_module"
                    or getattr(node.func, "id", None) == "__import__"):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import pathtracer_tpu_torch.integrator\n"
                   "from pathtracer_tpu.ops import x\n"
                   "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert top_level_imports(str(src)) == {"pathtracer_tpu_torch",
                                           "pathtracer_tpu", "importlib",
                                           "jax"}


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)
    assert top_level_imports(path) <= REFERENCE_MAY
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    depth = os.path.relpath(path, os.path.join(BENCH_DIR, "reference")) \
        .count(os.sep)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            # relative imports stay inside reference/
            assert node.level <= depth + 1 if node.level else True
