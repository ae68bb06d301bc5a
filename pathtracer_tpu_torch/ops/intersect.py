"""Ray-triangle intersection: watertight Woop-style test, fully batched.

Port of ``pathtracer_tpu/ops/intersect.py`` (the brute-force forms). This
is the plain PyTorch version of kernel K1 (``ops/cuda/intersect_cu.py``):
an (N rays x F triangles) grid of watertight tests, closest hit by argmin
(the lowest triangle index wins ties, as torch.argmin returns the first
minimum) and any-hit by OR.
"""

from __future__ import annotations

import torch

from ..core.math import gamma

# python floats holding the exact float32 values, so every tensor op
# multiplies by the same f32 constant as the reference
GAMMA2 = float(gamma(2))
GAMMA3 = float(gamma(3))
GAMMA5 = float(gamma(5))
GAMMA7 = float(gamma(7))


def _permute_ray(d):
    """Per-ray permutation indices (kx, ky, kz) with kz = argmax |d|."""
    ad = torch.abs(d)
    two = torch.full(ad.shape[:-1], 2, dtype=torch.int64, device=d.device)
    kz = torch.where(ad[..., 0] > ad[..., 1],
                     torch.where(ad[..., 0] > ad[..., 2], 0, two),
                     torch.where(ad[..., 1] > ad[..., 2], 1, two))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    return kx, ky, kz


def _take3(v, k):
    """v (..., 3), k (...,) int in {0,1,2} -> v[..., k] by selects."""
    return torch.where(k == 0, v[..., 0],
                       torch.where(k == 1, v[..., 1], v[..., 2]))


def _watertight(p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z, sz, t_max):
    """Edge functions, range test and conservative t bound on sheared
    vertices (shared by the grid and diagonal forms). Returns
    (t, b (..., 3), hit)."""
    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    edge_ok = ~(neg & pos)
    det = e0 + e1 + e2
    det_ok = det != 0.0
    p0z = p0z * sz
    p1z = p1z * sz
    p2z = p2z * sz
    t_scaled = e0 * p0z + e1 * p1z + e2 * p2z
    range_ok = torch.where(
        det < 0,
        (t_scaled < 0.0) & (t_scaled >= t_max * det),
        (t_scaled > 0.0) & (t_scaled <= t_max * det))
    inv_det = torch.reciprocal(torch.where(det_ok, det, 1.0))
    t = t_scaled * inv_det

    # conservative t error bound (ref shape.rs:163-184)
    def amax3(a, b, c):
        return torch.maximum(torch.abs(a), torch.maximum(torch.abs(b),
                                                         torch.abs(c)))
    max_zt = amax3(p0z, p1z, p2z)
    max_xt = amax3(p0x, p1x, p2x)
    max_yt = amax3(p0y, p1y, p2y)
    delta_z = GAMMA3 * max_zt
    delta_x = GAMMA5 * (max_xt + max_zt)
    delta_y = GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (GAMMA2 * max_xt * max_yt + delta_y * max_xt
                     + delta_x * max_yt)
    max_e = amax3(e0, e1, e2)
    delta_t = 3.0 * (GAMMA3 * max_e * max_zt + delta_e * max_zt
                     + delta_z * max_e) * torch.abs(inv_det)
    hit = edge_ok & det_ok & range_ok & (t > delta_t)
    b = torch.stack([e0 * inv_det, e1 * inv_det, e2 * inv_det], dim=-1)
    return t, b, hit


def watertight_hits(o, d, t_max, p0, p1, p2):
    """Watertight test of N rays against F triangles.

    o, d: (N, 3); t_max: (N,); p0/p1/p2: (F, 3).
    Returns (t (N, F), b (N, F, 3) barycentrics, hit (N, F) bool).
    """
    kx, ky, kz = _permute_ray(d)
    sx = -_take3(d, kx) / _take3(d, kz)
    sy = -_take3(d, ky) / _take3(d, kz)
    sz = torch.reciprocal(_take3(d, kz))

    def shear(p):
        pt = p[None, :, :] - o[:, None, :]  # (N, F, 3)
        px = _take3(pt, kx[:, None])
        py = _take3(pt, ky[:, None])
        pz = _take3(pt, kz[:, None])
        return px + sx[:, None] * pz, py + sy[:, None] * pz, pz

    return _watertight(*shear(p0), *shear(p1), *shear(p2), sz[:, None],
                       t_max[:, None])


def watertight_hit_diag(o, d, t_max, p0, p1, p2):
    """Watertight test of ray i against triangle i (diagonal pairing).

    o, d, p0/p1/p2: (N, 3); t_max: (N,). Same math as watertight_hits,
    elementwise.
    """
    kx, ky, kz = _permute_ray(d)
    sx = -_take3(d, kx) / _take3(d, kz)
    sy = -_take3(d, ky) / _take3(d, kz)
    sz = torch.reciprocal(_take3(d, kz))

    def shear(p):
        pt = p - o
        px, py, pz = _take3(pt, kx), _take3(pt, ky), _take3(pt, kz)
        return px + sx * pz, py + sy * pz, pz

    return _watertight(*shear(p0), *shear(p1), *shear(p2), sz, t_max)


def _sel3(k, c0, c1, c2):
    return torch.where(k == 0, c0, torch.where(k == 1, c1, c2))


def watertight_cols_pre(o, d):
    """Per-ray shear constants for watertight_hit_cols, as flat (N,)
    columns: the kz = argmax |d| permutation and the shear coefficients of
    watertight_hit_diag's prologue, computed once per ray so a traversal
    testing many triangles per ray hoists them out of its loop."""
    kx, ky, kz = _permute_ray(d)
    dz = _take3(d, kz)
    return dict(kx=kx, ky=ky, kz=kz, o0=o[..., 0], o1=o[..., 1],
                o2=o[..., 2], sx=-_take3(d, kx) / dz, sy=-_take3(d, ky) / dz,
                sz=torch.reciprocal(dz))


def watertight_hit_cols(pre, t_max, c9):
    """Watertight test of ray i against triangle i, all-columns form.

    pre: watertight_cols_pre(o, d), each column broadcastable against the
    triangle columns; t_max likewise; c9: 9 columns [p0.x p0.y p0.z p1.x ..
    p2.z] in world space. Returns (t, b0, b1, b2, hit). The same operations
    in the same order as watertight_hit_diag, so the same bits.
    """
    kx, ky, kz = pre["kx"], pre["ky"], pre["kz"]
    sx, sy, sz = pre["sx"], pre["sy"], pre["sz"]

    def shear(cx, cy, cz):
        a0 = cx - pre["o0"]
        a1 = cy - pre["o1"]
        a2 = cz - pre["o2"]
        pz = _sel3(kz, a0, a1, a2)
        return (_sel3(kx, a0, a1, a2) + sx * pz,
                _sel3(ky, a0, a1, a2) + sy * pz, pz)

    t, b, hit = _watertight(*shear(*c9[0:3]), *shear(*c9[3:6]),
                            *shear(*c9[6:9]), sz, t_max)
    return t, b[..., 0], b[..., 1], b[..., 2], hit


def intersect_brute(o, d, t_max, p0, p1, p2):
    """Closest hit over all triangles.

    Returns dict(valid (N,), t (N,), tri (N,) i32, b (N, 3)). As in the
    reference, b on a miss is triangle 0's barycentrics.
    """
    t, b, hit = watertight_hits(o, d, t_max, p0, p1, p2)
    t_masked = torch.where(hit, t, torch.inf)
    tri = torch.argmin(t_masked, dim=-1)
    t_best = torch.gather(t_masked, 1, tri[:, None])[:, 0]
    b_best = torch.gather(b, 1, tri[:, None, None].expand(-1, 1, 3))[:, 0]
    valid = torch.isfinite(t_best)
    return dict(valid=valid, t=torch.where(valid, t_best, 0.0),
                tri=tri.to(torch.int32), b=b_best)


def intersect_p_brute(o, d, t_max, p0, p1, p2):
    """Any-hit (shadow) test. Returns (N,) bool."""
    _, _, hit = watertight_hits(o, d, t_max, p0, p1, p2)
    return torch.any(hit, dim=-1)
