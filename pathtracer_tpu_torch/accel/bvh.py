"""Binary SAH BVH build on the host.

Port of the host half of ``pathtracer_tpu/accel/bvh.py``: the 12-bucket
SAH recursive build with leaves of at most ``max_prims`` triangles and the
flattened depth-first node layout (interior nodes store their second
child's index, the first child follows them). Above 20,000 triangles the
native C++ builder (``accel/cpp.py``) does the same build. The triangles
are reordered so each leaf's are contiguous; ``order`` is the permutation.

The binary tree is only the input of the 32-wide collapse
(``accel/bvhw.py``); its own traversal and packed node rows belong to the
alpha path (ROADMAP Queue 1 item 10b).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

N_BUCKETS = 12


@dataclasses.dataclass
class BVHArrays:
    """Flattened binary BVH as host numpy arrays (SoA LinearBVHNode)."""

    bounds_min: np.ndarray  # (M, 3) f32
    bounds_max: np.ndarray  # (M, 3) f32
    offset: np.ndarray  # (M,) i32: prims offset (leaf) or second child
    n_prims: np.ndarray  # (M,) i32, 0 for interior nodes
    axis: np.ndarray  # (M,) i32 split axis of interior nodes
    order: np.ndarray  # (F,) triangle permutation applied
    max_leaf: int


def build_bvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
              max_prims: int = 4, native: bool | None = None) -> BVHArrays:
    """12-bucket SAH build over triangle bounds (host).

    Uses the C++ builder when ``native`` (by default above 20,000
    triangles) and it compiles; otherwise the numpy build below.
    """
    if native is None:
        native = len(p0) > 20_000
    if native:
        from . import cpp
        if cpp.available():
            bmin, bmax, off, npr, ax, order = cpp.build(
                np.asarray(p0), np.asarray(p1), np.asarray(p2), max_prims)
            return BVHArrays(bounds_min=bmin, bounds_max=bmax, offset=off,
                             n_prims=npr, axis=ax, order=order,
                             max_leaf=max_prims)
    f = len(p0)
    lo = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    hi = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    centroid = 0.5 * (lo + hi)

    nb_min: list[np.ndarray] = []
    nb_max: list[np.ndarray] = []
    noffset: list[int] = []
    nprims: list[int] = []
    naxis: list[int] = []
    order: list[np.ndarray] = []
    n_ordered = 0

    def sa(e):
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def emit(b_lo, b_hi, off, np_, ax):
        nb_min.append(b_lo)
        nb_max.append(b_hi)
        noffset.append(off)
        nprims.append(np_)
        naxis.append(ax)
        return len(nb_min) - 1

    rec_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec_limit, 10_000 + f))

    def build(prims) -> int:
        nonlocal n_ordered
        b_lo = lo[prims].min(0)
        b_hi = hi[prims].max(0)

        def leaf():
            nonlocal n_ordered
            idx = emit(b_lo, b_hi, n_ordered, len(prims), 0)
            order.append(prims)
            n_ordered += len(prims)
            return idx

        if len(prims) <= max_prims:
            return leaf()
        c = centroid[prims]
        c_lo, c_hi = c.min(0), c.max(0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        # coincident centroids must still split (equal-count median below):
        # a leaf above max_prims would not fit its leaf row
        best_cost, best_split = np.inf, -1
        if extent[axis] > 0:
            scaled = np.minimum(((c[:, axis] - c_lo[axis]) / extent[axis]
                                 * N_BUCKETS).astype(np.int32), N_BUCKETS - 1)
            bl, bh = lo[prims], hi[prims]
            for split in range(N_BUCKETS - 1):
                left = scaled <= split
                nl = int(left.sum())
                nr = len(prims) - nl
                if nl == 0 or nr == 0:
                    continue
                cost = 0.125 + (nl * sa(bh[left].max(0) - bl[left].min(0)) +
                                nr * sa(bh[~left].max(0) - bl[~left].min(0))) \
                    / max(sa(b_hi - b_lo), 1e-20)
                if cost < best_cost:
                    best_cost, best_split = cost, split
        if best_split < 0:
            med = np.argsort(c[:, axis], kind="stable")
            half = len(prims) // 2
            li, ri = prims[med[:half]], prims[med[half:]]
        else:
            mask = scaled <= best_split
            li, ri = prims[mask], prims[~mask]

        node = emit(b_lo, b_hi, 0, 0, axis)
        left_idx = build(li)
        if left_idx != node + 1:
            raise AssertionError("first child must follow its parent")
        noffset[node] = build(ri)
        return node

    try:
        build(np.arange(f))
    finally:
        sys.setrecursionlimit(rec_limit)
    return BVHArrays(
        bounds_min=np.stack(nb_min), bounds_max=np.stack(nb_max),
        offset=np.asarray(noffset, np.int32),
        n_prims=np.asarray(nprims, np.int32),
        axis=np.asarray(naxis, np.int32),
        order=np.concatenate(order) if order else np.arange(0),
        max_leaf=max_prims)
