"""A numpy model of kernel K1's algorithm, held to its plain version.

``csrc/intersect.cu`` cannot run on the CPU, so this file models what it
does, step by step, in float32 numpy, and holds the model bit for bit to
``intersect_plain`` (``ops/cuda/intersect_cu.py``) on the same inputs:

- the pre-permuted tile: each triangle copied once for each kz, in
  (kx, ky, kz) order, the ray's copy read without a select;
- the hot loop: shear and the three edge functions only, each triangle
  that passes the sign test a bit of a per-thread candidate mask of
  ``chunk`` triangles;
- the tail after each chunk: the mask walked from its lowest bit, the
  candidate sheared again and tested (det, range, 1/det, t < best_t, the
  error bound); any hit stops at the first candidate that passes;
- dead lanes (t_max not > 0) test nothing.

Small chunks and tiles put the chunk and tile boundaries everywhere, and
a stack of triangles that every ray crosses fills every chunk: more
candidates than one mask holds.
"""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops.cuda.intersect_cu import intersect_plain
from pathtracer_tpu_torch.ops.intersect import GAMMA2, GAMMA3, GAMMA5
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32


def _perm(kz):
    """(kx, ky, kz) with the kernel's rule."""
    kx = np.where(kz == 2, 0, kz + 1)
    return kx, np.where(kx == 2, 0, kx + 1), kz


def _shear(copy, ox, oy, oz, sx, sy):
    """The kernel's ``shear`` on (..., 9) pre-permuted copies."""
    a = [copy[..., 3 * v + c] - (ox, oy, oz)[c] for v in range(3)
         for c in range(3)]
    az = (a[2], a[5], a[8])
    px = [a[3 * v] + sx * az[v] for v in range(3)]
    py = [a[3 * v + 1] + sy * az[v] for v in range(3)]
    e0 = px[1] * py[2] - py[1] * px[2]
    e1 = px[2] * py[0] - py[2] * px[0]
    e2 = px[0] * py[1] - py[0] * px[1]
    return az, px, py, (e0, e1, e2)


def _edges_agree(e):
    """The kernel's sign test: the least edge value >= 0 or the greatest
    <= 0, NaN skipped (np.fmin / np.fmax, as fminf / fmaxf)."""
    return (np.fmin(e[0], np.fmin(e[1], e[2])) >= 0) | \
        (np.fmax(e[0], np.fmax(e[1], e[2])) <= 0)


def _amax3(a, b, c):
    return np.maximum(np.abs(a), np.maximum(np.abs(b), np.abs(c)))


def _tail(az, px, py, e, sz, tm, best_t, closest):
    """The kernel's ``hit_tail``: (hit, t, inv_det), elementwise."""
    with np.errstate(all="ignore"):
        det = e[0] + e[1] + e[2]
        pz = [az[v] * sz for v in range(3)]
        t_scaled = e[0] * pz[0] + e[1] * pz[1] + e[2] * pz[2]
        lim = tm * det
        range_ok = np.where(det < 0, (t_scaled < 0) & (t_scaled >= lim),
                            (t_scaled > 0) & (t_scaled <= lim))
        inv_det = F32(1) / np.where(det != 0, det, F32(1))
        t = t_scaled * inv_det
        max_zt, max_xt, max_yt = _amax3(*pz), _amax3(*px), _amax3(*py)
        delta_z = F32(GAMMA3) * max_zt
        delta_x = F32(GAMMA5) * (max_xt + max_zt)
        delta_y = F32(GAMMA5) * (max_yt + max_zt)
        delta_e = F32(2) * (F32(GAMMA2) * max_xt * max_yt + delta_y * max_xt
                            + delta_x * max_yt)
        max_e = _amax3(*e)
        delta_t = F32(3) * (F32(GAMMA3) * max_e * max_zt + delta_e * max_zt
                            + delta_z * max_e) * np.abs(inv_det)
        hit = (det != 0) & range_ok & (t > delta_t)
        if closest:
            hit &= t < best_t
    return hit, t, inv_det


def _lowest_bit(mask):
    """__ffs - 1 of each nonzero uint64 mask."""
    low = mask & (~mask + np.uint64(1))
    return np.log2(low.astype(np.float64)).astype(np.int64)


def k1_model(o, d, t_max, tri_pack, any_hit=False, chunk=32, tile=256,
             stats=None):
    """Kernel K1's algorithm in float32 numpy, one thread a ray, with
    ``chunk`` triangles a candidate mask (the kernel's 32) and ``tile``
    triangles a shared-memory tile (its 256). Returns the wrapper's
    outputs as numpy arrays. ``stats`` (a dict) receives each chunk's
    candidates a lane and its size."""
    n, f = o.shape[0], tri_pack.shape[0]
    rows = np.arange(n)
    with np.errstate(all="ignore"):
        ad = np.abs(d)
        kz = np.where(ad[:, 0] > ad[:, 1], np.where(ad[:, 0] > ad[:, 2], 0, 2),
                      np.where(ad[:, 1] > ad[:, 2], 1, 2))
        kx, ky, _ = _perm(kz)
        d_x, d_y, d_z = d[rows, kx], d[rows, ky], d[rows, kz]
        sx, sy, sz = -d_x / d_z, -d_y / d_z, F32(1) / d_z
    ox, oy, oz = o[rows, kx], o[rows, ky], o[rows, kz]
    live = t_max > 0
    # the tile's three copies of each triangle: (3 kz, F, 9)
    copies = np.stack([tri_pack[:, [3 * v + c for v in range(3)
                                     for c in _perm(np.array(z))]]
                       for z in range(3)])
    my_copies = copies[kz]  # (N, F, 9): the copy a ray's thread reads

    def shear_at(lanes, j):
        c = my_copies[lanes, j]
        return _shear(c, ox[lanes], oy[lanes], oz[lanes], sx[lanes],
                      sy[lanes])

    best_t = np.full(n, np.inf, F32)
    best_tri = np.zeros(n, np.int64)
    bb = np.zeros((n, 3), F32)
    found = np.zeros(n, bool)
    done = ~live
    for base in range(0, f, tile):
        cnt = min(tile, f - base)
        for c0 in range(0, cnt, chunk):
            m = min(chunk, cnt - c0)
            lanes = np.nonzero(~done)[0]
            cand = np.zeros(n, np.uint64)
            with np.errstate(all="ignore"):
                for k in range(m):
                    _, _, _, e = shear_at(lanes, base + c0 + k)
                    bit = _edges_agree(e).astype(np.uint64) << np.uint64(k)
                    cand[lanes] |= bit
            if stats is not None:
                stats.setdefault("candidates", []).append(
                    np.array([bin(int(x)).count("1") for x in cand]))
                stats.setdefault("chunk_sizes", []).append(m)
            while True:
                lanes = np.nonzero((cand != 0) & ~done)[0]
                if lanes.size == 0:
                    break
                j = c0 + _lowest_bit(cand[lanes])
                cand[lanes] &= cand[lanes] - np.uint64(1)
                with np.errstate(all="ignore"):
                    az, px, py, e = shear_at(lanes, base + j)
                hit, t, inv_det = _tail(az, px, py, e, sz[lanes],
                                        t_max[lanes], best_t[lanes],
                                        not any_hit)
                lanes, t, inv_det = lanes[hit], t[hit], inv_det[hit]
                e = [x[hit] for x in e]
                if any_hit:
                    found[lanes] = True
                    done[lanes] = True
                    continue
                best_t[lanes] = t
                best_tri[lanes] = base + j[hit]
                bb[lanes] = np.stack([x * inv_det for x in e], axis=-1)
    if any_hit:
        return found
    valid = best_t < np.inf
    return dict(valid=valid, t=np.where(valid, best_t, F32(0)),
                tri=best_tri.astype(np.int32), b=bb)


def _soup(seed, f, n):
    """Random triangles and rays; a quarter of the rays get a finite
    t_max, and some are dead (t_max 0, -1 or NaN); directions include
    axis-parallel ones and |dx| == |dy| ties of the kz rule."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (f, 3))
    p = [base, base + rng.normal(0, 0.5, (f, 3)),
         base + rng.normal(0, 0.5, (f, 3)), np.zeros((f, 3))]
    o = rng.uniform(-3, 3, (n, 3))
    d = rng.normal(size=(n, 3))
    d[::11] = [1.0, 0.0, 0.0]
    d[5::11] = [0.0, -1.0, 0.0]
    d[7::11, 1] = -d[7::11, 0]
    t_max = np.where(rng.uniform(size=n) < 0.25, rng.uniform(0.5, 4.0, n),
                     np.inf)
    t_max[3::17] = 0.0
    t_max[4::17] = -1.0
    t_max[6::17] = np.nan
    return (np.float32(o), np.float32(d), np.float32(t_max),
            np.float32(np.concatenate(p, axis=1)))


def _case(name):
    if name == "soup":
        return _soup(1, 70, 600)
    if name == "ties":  # every triangle twice: the same t at two indices
        o, d, t_max, tri = _soup(2, 35, 600)
        return o, d, t_max, np.concatenate([tri, tri])
    if name == "stack":
        # 100 triangles at z = 1..100 that every ray from near the origin
        # along +z crosses: 100 candidates a ray, more than one mask holds
        rng = np.random.default_rng(3)
        z = np.arange(1, 101, dtype=np.float64)[:, None]
        tri = np.concatenate([np.c_[-50 + 0 * z, -50 + 0 * z, z],
                              np.c_[50 + 0 * z, -50 + 0 * z, z],
                              np.c_[0 * z, 50 + 0 * z, z],
                              np.zeros((100, 3))], axis=1)
        tri = tri[rng.permutation(100)]
        n = 300
        o = rng.uniform(-0.5, 0.5, (n, 3)) * [1, 1, 0]
        d = np.c_[rng.normal(0, 0.05, (n, 2)), np.ones(n)]
        t_max = np.where(rng.uniform(size=n) < 0.3, rng.uniform(0.2, 90, n),
                         np.inf)
        return (np.float32(o), np.float32(d), np.float32(t_max),
                np.float32(tri))
    # cornell's 36 triangles, rays from inside the room
    _, sd, _ = load_mitsuba(os.path.join(ROOT, "data", "cornell-box.xml"),
                            resolution=(8, 8), device="cpu")
    tri = np.concatenate([sd.p0.numpy(), sd.p1.numpy(), sd.p2.numpy(),
                          np.zeros((sd.p0.shape[0], 3), np.float32)], axis=1)
    rng = np.random.default_rng(4)
    lo, hi = tri[:, :9].reshape(-1, 3).min(0), tri[:, :9].reshape(-1, 3).max(0)
    o = lo + (hi - lo) * rng.uniform(0.1, 0.9, (800, 3))
    d = rng.normal(size=(800, 3))
    return (np.float32(o), np.float32(d),
            np.float32(np.where(rng.uniform(size=800) < 0.5, np.inf, 1.0)),
            np.float32(tri))


# (chunk, tile): the kernel's, and smaller chunks and tiles that put
# their boundaries everywhere
LAYOUTS = [(32, 256), (32, 64), (4, 8), (3, 12), (2, 8), (1, 4)]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("name", ["soup", "ties", "stack", "cornell"])
def test_model_matches_plain(name, layout):
    chunk, tile = layout
    o, d, t_max, tri = _case(name)
    stats = {}
    got = k1_model(o, d, t_max, tri, chunk=chunk, tile=tile, stats=stats)
    got_any = k1_model(o, d, t_max, tri, any_hit=True, chunk=chunk,
                       tile=tile)
    args = [torch.from_numpy(x) for x in (o, d, t_max, tri)]
    want = intersect_plain(*args)
    want_any = intersect_plain(*args, any_hit=True)
    for key in ("valid", "t", "tri", "b"):
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(got[key])),
                           want[key]), key
    assert torch.equal(torch.from_numpy(got_any), want_any)
    hit = want["valid"].numpy()
    assert hit.any() and not hit.all()
    if name == "ties":  # a hit on a copy: the first of the pair wins
        assert (got["tri"][hit] < 35).all()
    if name == "stack":  # every chunk fills up: 100 candidates a ray
        for c, m in zip(stats["candidates"], stats["chunk_sizes"]):
            assert c.max() == m
        assert sum(c.max() for c in stats["candidates"]) == 100 > chunk


def test_dead_lanes_are_misses():
    """t_max 0, -0, -1, -inf and NaN: no candidate is tested and the miss
    record comes out, as the plain version's range test gives."""
    o, d, _, tri = _case("stack")
    t_max = np.float32([0.0, -0.0, -1.0, -np.inf, np.nan] * 60)
    stats = {}
    got = k1_model(o, d, t_max, tri, stats=stats)
    assert all((c == 0).all() for c in stats["candidates"])
    want = intersect_plain(*[torch.from_numpy(x) for x in (o, d, t_max, tri)])
    assert not want["valid"].any()
    for key in ("valid", "t", "tri", "b"):
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(got[key])),
                           want[key]), key
