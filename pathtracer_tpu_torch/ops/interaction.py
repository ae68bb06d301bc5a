"""Surface interaction construction from hit records (SoA tensors).

Port of ``pathtracer_tpu/ops/interaction.py``: the interaction frame,
the screen-space UV derivatives of the camera rays' differentials
(``compute_duv``) and the tangent-space normal maps
(``apply_normal_mapping``). Per-hit triangle data is one packed row
fetch, ``tri_attr[tri]``.
"""

from __future__ import annotations

import torch

from ..core import math as pm
from ..scene.scene import (TA_DPDU, TA_HASN, TA_KE, TA_LID, TA_MAT, TA_N0,
                           TA_N1, TA_N2, TA_NG0, TA_NGF, TA_P0, TA_P1, TA_P2,
                           TA_UV0, TA_UV1, TA_UV2, TA_DPDV)
from .bsdf import eval_texture
from .intersect import GAMMA7


def make_interaction(scene, o, d, hit, tri_attr):
    """Build SoA interaction data for a batch of hits.

    scene: SceneData (unused; kept for the reference's signature); o, d:
    (N, 3); hit: dict from intersect;
    tri_attr: (F, TA_WIDTH) packed rows. Entries are garbage where
    hit["valid"] is False (the caller masks).
    """
    tri = hit["tri"]
    b = hit["b"]
    rows = tri_attr[tri.long()]
    p0, p1, p2 = rows[:, TA_P0], rows[:, TA_P1], rows[:, TA_P2]
    uv0, uv1, uv2 = rows[:, TA_UV0], rows[:, TA_UV1], rows[:, TA_UV2]

    b0, b1, b2 = b[..., 0:1], b[..., 1:2], b[..., 2:3]
    p_hit = b0 * p0 + b1 * p1 + b2 * p2
    uv_hit = b0 * uv0 + b1 * uv1 + b2 * uv2
    p_error = GAMMA7 * (torch.abs(b0 * p0) + torch.abs(b1 * p1)
                        + torch.abs(b2 * p2))

    dpdu = rows[:, TA_DPDU]
    dpdv = rows[:, TA_DPDV]
    ng = rows[:, TA_NG0]

    # shading geometry
    has_n = rows[:, TA_HASN] > 0.5
    ns_interp = b0 * rows[:, TA_N0] + b1 * rows[:, TA_N1] + \
        b2 * rows[:, TA_N2]
    ns_len = pm.norm_sq(ns_interp)
    ns = torch.where(
        (has_n & (ns_len > 0.0))[..., None],
        ns_interp / pm.sqrt(torch.clamp_min(ns_len, 1e-30))[..., None], ng)
    # geometric normal face-forwarded to the shading normal
    ng = torch.where(has_n[..., None], pm.face_forward(ng, ns), ng)

    # shading tangent frame
    ss0 = pm.normalize(dpdu)
    ts = pm.cross(ss0, ns)
    ts_len = pm.norm_sq(ts)
    ts_n = ts / pm.sqrt(torch.clamp_min(ts_len, 1e-30))[..., None]
    ss = torch.where((ts_len > 0.0)[..., None], pm.cross(ts_n, ns), ss0)
    cs_u, _ = pm.coordinate_system(ns)
    ss = torch.where((ts_len > 0.0)[..., None], ss, cs_u)

    return dict(
        p=p_hit, p_error=p_error, uv=uv_hit, wo=-d,
        ng=ng, ns=ns, ss=ss, ts=pm.cross(ns, ss),
        dpdu=dpdu, dpdv=dpdv,
        material=rows[:, TA_MAT].to(torch.int32),
        area_light=rows[:, TA_LID].to(torch.int32),
        ke=rows[:, TA_KE],
        tri=tri,
    )


def compute_duv(it, o, rxd, ryd):
    """Screen-space (u, v) derivatives at hits.

    Intersects the two auxiliary camera rays (shared origin o, directions
    rxd / ryd) with the tangent plane at the hit, then solves [dpdu dpdv]
    [du dv]^T = dp in the two dimensions the normal leaves most stable.
    Returns (dudx, dvdx, dudy, dvdy), zeros where a plane hit is not
    finite, the system is singular (|det| < 1e-10) or the solution is not
    finite. The dimension pick tests n.z, the reference's recorded
    deviation from the code it was modelled on (which compares n.y twice).
    """
    n = it["ng"]
    p = it["p"]
    d_plane = pm.dot(n, p)

    def plane_hit(rd):
        t = -(pm.dot(n, o) - d_plane) / pm.dot(n, rd)
        return o + t[..., None] * rd, torch.isfinite(t)

    px, okx = plane_hit(rxd)
    py, oky = plane_hit(ryd)
    dpdx = px - p
    dpdy = py - p

    an = torch.abs(n)
    use_x = (an[..., 0] > an[..., 1]) & (an[..., 0] > an[..., 2])
    use_y = ~use_x & (an[..., 1] > an[..., 2])
    dim0 = torch.where(use_x, 1, 0)
    dim1 = torch.where(use_x | use_y, 2, 1)

    def take(v, k):
        return torch.where(k == 0, v[..., 0],
                           torch.where(k == 1, v[..., 1], v[..., 2]))

    a00 = take(it["dpdu"], dim0)
    a01 = take(it["dpdv"], dim0)
    a10 = take(it["dpdu"], dim1)
    a11 = take(it["dpdv"], dim1)
    det = a00 * a11 - a01 * a10
    ok_det = torch.abs(det) >= 1e-10
    inv_det = 1.0 / torch.where(ok_det, det, 1.0)
    ok = okx & oky

    def solve(dp):
        b0, b1 = take(dp, dim0), take(dp, dim1)
        du = (a11 * b0 - a01 * b1) * inv_det
        dv = (a00 * b1 - a10 * b0) * inv_det
        good = ok & ok_det & torch.isfinite(du) & torch.isfinite(dv)
        return torch.where(good, du, 0.0), torch.where(good, dv, 0.0)

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    return dudx, dvdx, dudy, dvdy


def apply_normal_mapping(scene, it, duv=None):
    """Perturb the shading frame by the materials' tangent-space normal
    maps: n' = normalize(n_tex in the (ss, ts, ns) frame), then the
    tangent frame rebuilt around it; lanes whose material binds no map
    keep their frame."""
    ntx = scene.mat_normal_tx[it["material"].long()]
    has = ntx >= 0
    flat = pm.device_const((0.5, 0.5, 1.0), it["ns"].device)
    rgb = eval_texture(scene, ntx, it["uv"], flat.expand(it["ns"].shape),
                       duv=duv)
    n_tan = pm.normalize(2.0 * rgb - 1.0)
    ns_new = pm.normalize(
        n_tan[..., 0:1] * it["ss"] + n_tan[..., 1:2] * it["ts"]
        + n_tan[..., 2:3] * it["ns"])
    ss0 = it["ss"]
    ts = pm.cross(ss0, ns_new)
    ts_len = pm.norm_sq(ts)
    ts_n = ts / pm.sqrt(torch.clamp_min(ts_len, 1e-30))[..., None]
    ss = torch.where((ts_len > 0.0)[..., None], pm.cross(ts_n, ns_new), ss0)
    cs_u, _ = pm.coordinate_system(ns_new)
    ss = torch.where((ts_len > 0.0)[..., None], ss, cs_u)
    out = dict(it)
    out["ns"] = torch.where(has[..., None], ns_new, it["ns"])
    out["ss"] = torch.where(has[..., None], ss, it["ss"])
    out["ts"] = torch.where(has[..., None], pm.cross(ns_new, ss), it["ts"])
    out["ng"] = torch.where(has[..., None],
                            pm.face_forward(it["ng"], ns_new), it["ng"])
    return out

def emitted_radiance(it, w):
    """Le at a hit toward w (one-sided area light); zero where the hit is
    not an emitter or faces away."""
    is_emitter = it["area_light"] >= 0
    facing = pm.dot(it["ng"], w) > 0.0
    return torch.where((is_emitter & facing)[..., None], it["ke"], 0.0)


def hit_emission(tri_attr, hit, w):
    """(Le, area-light id) at a raw hit record, one packed row fetch,
    using the face-forwarded per-triangle normal for the one-sided test."""
    rows = tri_attr[hit["tri"].long()]
    lid = rows[:, TA_LID].to(torch.int32)
    is_emitter = hit["valid"] & (lid >= 0)
    facing = pm.dot(rows[:, TA_NGF], w) > 0.0
    le = torch.where((is_emitter & facing)[..., None], rows[:, TA_KE], 0.0)
    return le, torch.where(hit["valid"], lid, -1)


def spawn_ray(p, p_error, n, d):
    """Offset origin robustly along n for direction d."""
    return pm.offset_ray_origin(p, p_error, n, d)


def spawn_ray_to(p, p_error, n, target_p, target_err, target_n):
    """Shadow ray between two interactions.

    Returns (origin, direction (unnormalized), t_max = 1 - SHADOW_EPSILON).
    """
    o = pm.offset_ray_origin(p, p_error, n, target_p - p)
    tgt = pm.offset_ray_origin(target_p, target_err, target_n, o - target_p)
    d = tgt - o
    t_max = torch.full(d.shape[:-1], float(1.0 - pm.SHADOW_EPSILON),
                       dtype=d.dtype, device=d.device)
    return o, d, t_max
