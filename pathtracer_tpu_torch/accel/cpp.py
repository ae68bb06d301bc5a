"""ctypes binding for the native SAH BVH builder.

Port of ``pathtracer_tpu/accel/cpp/__init__.py``. It compiles this
package's ``csrc/bvh_builder.cpp`` (a byte-identical copy of the JAX
package's builder source) with g++ into the gitignored ``build/``, keyed
by a hash of the source and flags.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..ops.cuda._build import CSRC_DIR, build_library

SOURCE = os.path.join(CSRC_DIR, "bvh_builder.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> str:
    """Compile the builder into build/ (once). Returns the library's path."""
    return build_library(SOURCE, "g++", GXX_FLAGS)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(library_path())
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.pt_build_bvh.restype = ctypes.c_int
        lib.pt_build_bvh.argtypes = [
            f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, i32p, i32p,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def build(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray, max_leaf: int = 4):
    """Native SAH build. Returns (bounds_min, bounds_max, offset, n_prims,
    axis, order) numpy arrays (node arrays cut to the real node count)."""
    lib = _load()
    n = len(p0)
    cap = max(2 * n, 16)
    out_min = np.empty((cap, 3), np.float32)
    out_max = np.empty((cap, 3), np.float32)
    out_offset = np.empty(cap, np.int32)
    out_nprims = np.empty(cap, np.int32)
    out_axis = np.empty(cap, np.int32)
    out_order = np.empty(n, np.int32)
    m = lib.pt_build_bvh(
        np.ascontiguousarray(p0, np.float32),
        np.ascontiguousarray(p1, np.float32),
        np.ascontiguousarray(p2, np.float32),
        n, max_leaf, out_min, out_max, out_offset, out_nprims, out_axis,
        out_order)
    return (out_min[:m].copy(), out_max[:m].copy(), out_offset[:m].copy(),
            out_nprims[:m].copy(), out_axis[:m].copy(), out_order)
