"""Surface interaction construction from hit records (SoA tensors).

Port of ``pathtracer_tpu/ops/interaction.py`` without ray differentials
and normal mapping (ROADMAP Queue 1 item 10b). Per-hit triangle data is one
packed row fetch, ``tri_attr[tri]``.
"""

from __future__ import annotations

import torch

from ..core import math as pm
from ..scene.scene import (TA_DPDU, TA_HASN, TA_KE, TA_LID, TA_MAT, TA_N0,
                           TA_N1, TA_N2, TA_NG0, TA_NGF, TA_P0, TA_P1, TA_P2,
                           TA_UV0, TA_UV1, TA_UV2, TA_DPDV)
from .intersect import GAMMA7


def make_interaction(scene, o, d, hit, tri_attr):
    """Build SoA interaction data for a batch of hits.

    scene: SceneData (unused by the untextured slice; kept for the
    reference's signature); o, d: (N, 3); hit: dict from intersect;
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
