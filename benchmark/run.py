"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cells;
``harness/manifest.py`` says where each named file lies. Set-up
(``setup_s``) is timed from the first statement below.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT_DIR = os.path.dirname(BENCH_DIR)
# every build and kernel cache inside the checkout, at fixed paths
CACHE_DIR = os.path.join(ROOT_DIR, ".benchmark_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
sys.path[:0] = [BENCH_DIR, ROOT_DIR]

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
