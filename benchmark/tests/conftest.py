"""The benchmark's own tests (``python -m pytest benchmark/tests``).

They import no JAX. The CPU tests drive the harness on the CPU at small
sizes; the tests marked ``cuda`` need a card and skip without one,
deciding inside their fixture.
"""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_DIR = os.path.dirname(BENCH_DIR)
for path in (ROOT_DIR, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
