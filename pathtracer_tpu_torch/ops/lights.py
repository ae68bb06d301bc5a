"""Light sampling: area (triangle), point, distant and infinite lights.

Port of ``sample_li`` / ``pdf_li`` of ``pathtracer_tpu/ops/lights.py``
with the triangle sampling (``_tri_sample``, ``_tri_pdf_along_sampled``)
and the environment light (``env_direction_to_uv``, ``env_lookup``,
``env_le``, ``_env_sample_li``, ``env_pdf_li``), and the emission API
the light tracer builds on: ``power``, ``sample_le`` and ``pdf_le``, with
PBRT-v3's semantics (the reference's own Light trait leaves them
unimplemented). Every light type in ``light_set`` is evaluated for the
whole batch and the per-ray result is selected by the chosen light's type.
``sample_li`` and ``pdf_li`` each run in a ``pt::light`` span, and
``env_le``, ``env_pdf_li``, ``env_le_pdf`` and ``_env_sample_li`` each in
a ``pt::env`` span (``utils/spans.py``), opened only where they are
called: the latter in a scene with an environment. On the card each of
the latter is one launch of kernel K8 (``ops/cuda/env_cu.py``); on the CPU
each runs its plain twin, ``env_eval_plain`` or ``env_sample_plain``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import math as pm
from ..core.math import gamma
from ..core.sampling import (concentric_sample_disk,
                             cosine_sample_hemisphere, pdf_distribution_2d,
                             sample_distribution_2d, uniform_sample_sphere,
                             uniform_sample_triangle)
from ..scene.scene import (LA_EMIT, LA_HASN, LA_N0, LA_N1, LA_N2, LA_P0,
                           LA_P1, LA_P2, LA_TYPE, LA_VEC, LIGHT_AREA,
                           LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_POINT)
from ..utils.spans import span
from .bsdf import select
from .cuda import env_cu
from .intersect import watertight_hit_diag

GAMMA6 = float(gamma(6))
ALL_LIGHTS = (LIGHT_AREA, LIGHT_POINT, LIGHT_DISTANT, LIGHT_INFINITE)


def _tri_area(p0, p1, p2):
    return 0.5 * pm.norm(pm.cross(p1 - p0, p2 - p0))


def _tri_sample(rows, u):
    """Uniform point on the light's triangle with face-forwarded normal.
    rows: (N, LA_WIDTH) light rows. Returns (p, n, p_error)."""
    p0, p1, p2 = rows[:, LA_P0], rows[:, LA_P1], rows[:, LA_P2]
    b = uniform_sample_triangle(u)
    b0, b1 = b[..., 0:1], b[..., 1:2]
    b2 = 1.0 - b0 - b1
    p = b0 * p0 + b1 * p1 + b2 * p2
    n = pm.normalize(pm.cross(p1 - p0, p2 - p0))
    has_n = rows[:, LA_HASN] > 0.5
    ns = b0 * rows[:, LA_N0] + b1 * rows[:, LA_N1] + b2 * rows[:, LA_N2]
    n = torch.where(has_n[..., None], pm.face_forward(n, ns), n)
    p_err = GAMMA6 * (torch.abs(b0 * p0) + torch.abs(b1 * p1)
                      + torch.abs(b2 * p2))
    return p, n, p_err


def _mat3_rows(m, w):
    """w @ m.T for (..., 3) vectors and a (3, 3) matrix, summed in index
    order (no BLAS, so the CPU and the card round alike)."""
    return w[..., 0:1] * m[:, 0] + w[..., 1:2] * m[:, 1] + \
        w[..., 2:3] * m[:, 2]


def _env_theta_uv(scene, w_world):
    """The polar angle theta of world directions in the map's frame, and
    their equirect uv."""
    w = pm.normalize(_mat3_rows(scene.world_to_env, w_world))
    theta = pm.spherical_theta(w)
    uv = torch.stack([pm.spherical_phi(w) * pm.INV_2_PI, theta * pm.INV_PI],
                     dim=-1)
    return theta, uv


def env_direction_to_uv(scene, w_world):
    """World direction -> equirect uv of the environment map."""
    return _env_theta_uv(scene, w_world)[1]


def env_lookup(scene, uv):
    """Bilinear lookup of the environment map at uv (level 0; repeat wrap
    in u, clamp in v)."""
    img = scene.env_map
    h, w = img.shape[0], img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    xm = torch.remainder(x0, w)
    xp = torch.remainder(x0 + 1, w)
    ym = torch.clamp(y0, 0, h - 1)
    yp = torch.clamp(y0 + 1, 0, h - 1)
    top = img[ym, xm] * (1 - fx) + img[ym, xp] * fx
    bot = img[yp, xm] * (1 - fx) + img[yp, xp] * fx
    return top * (1 - fy) + bot * fy


def env_eval_plain(scene, d_world, le: bool = True, pdf: bool = False):
    """The environment's radiance (N, 3; zero without an environment) and
    solid-angle pdf (N,) along world directions, each where asked (else
    None), from one uv of each direction: the plain twin of kernel K8's
    ``env_eval`` (``ops/cuda/env_cu.py``), which CPU tensors take."""
    theta, uv = _env_theta_uv(scene, d_world)
    out_le = out_pdf = None
    if le:
        out_le = env_lookup(scene, uv)
        out_le = torch.where(scene.has_env, out_le, torch.zeros_like(out_le))
    if pdf:
        sin_t = torch.sin(theta)
        d2 = pdf_distribution_2d(scene.env_cond_func, scene.env_marg_int, uv)
        out_pdf = d2 / (2.0 * np.pi * np.pi * torch.clamp_min(sin_t, 1e-20))
        out_pdf = torch.where((sin_t == 0.0) | ~scene.has_env, 0.0, out_pdf)
    return out_le, out_pdf


def env_sample_plain(scene, u):
    """Importance-sample the environment's 2D table at u (N, 2). Returns
    (wi_world, pdf (solid angle), radiance): the plain twin of kernel K8's
    ``env_sample`` (``ops/cuda/env_cu.py``), which CPU tensors take."""
    uv, map_pdf = sample_distribution_2d(
        scene.env_cond_func, scene.env_cond_cdf, scene.env_cond_int,
        scene.env_marg_func, scene.env_marg_cdf, scene.env_marg_int, u)
    theta = uv[..., 1] * np.pi
    phi = uv[..., 0] * 2.0 * np.pi
    sin_t = torch.sin(theta)
    w_local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                           torch.cos(theta)], dim=-1)
    wi = _mat3_rows(scene.env_to_world, w_local)
    pdf = torch.where(sin_t == 0.0, 0.0,
                      map_pdf / (2.0 * np.pi * np.pi
                                 * torch.clamp_min(sin_t, 1e-20)))
    le = env_lookup(scene, uv)
    ok = map_pdf > 0.0
    return wi, torch.where(ok, pdf, 0.0), torch.where(ok[..., None], le, 0.0)


def _in_span(name: str):
    """``fn`` run inside a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inside(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inside
    return wrap


_env_span = _in_span("pt::env")
_light_span = _in_span("pt::light")


@_env_span
def env_le(scene, d_world):
    """Radiance of the environment along world directions (zero without
    an environment)."""
    return env_cu.env_eval(scene, d_world, le=True)[0]


@_env_span
def env_pdf_li(scene, w_world):
    """Solid-angle pdf of the environment light along world directions."""
    return env_cu.env_eval(scene, w_world, le=False, pdf=True)[1]


@_env_span
def env_le_pdf(scene, d_world):
    """``env_le`` and ``env_pdf_li`` along the same directions, in one
    call: (radiance (N, 3), pdf (N,))."""
    return env_cu.env_eval(scene, d_world, le=True, pdf=True)


@_env_span
def _env_sample_li(scene, u):
    """Importance-sample the environment's 2D table at u (N, 2). Returns
    (wi_world, pdf (solid angle), radiance)."""
    return env_cu.env_sample(scene, u)


def _tri_pdf_along_sampled(rows, ref_p, ref_err, ref_n, wi):
    """Solid-angle pdf of the light triangle along wi, by re-intersecting
    that one triangle from the offset reference point."""
    o = pm.offset_ray_origin(ref_p, ref_err, ref_n, wi)
    p0, p1, p2 = rows[:, LA_P0], rows[:, LA_P1], rows[:, LA_P2]
    t, _, hit = watertight_hit_diag(
        o, wi, torch.full(wi.shape[:-1], torch.inf, dtype=wi.dtype,
                          device=wi.device), p0, p1, p2)
    hp = o + t[..., None] * wi
    n = pm.normalize(pm.cross(p0 - p2, p1 - p2))
    area = _tri_area(p0, p1, p2)
    dist_sq = pm.norm_sq(ref_p - hp)
    cos_abs = torch.abs(pm.dot(n, -wi))
    pdf = dist_sq / torch.clamp_min(cos_abs * area, 1e-20)
    return torch.where(hit, pdf, 0.0)


@_light_span
def sample_li(scene, light_rows, ref_p, ref_err, ref_n, u,
              light_set=ALL_LIGHTS):
    """sample_li for each ray's chosen light.

    light_rows: (N, LA_WIDTH) rows of the chosen lights; light_set: the
    light types present (the others are not evaluated; with one type, its
    result holds for every lane). Returns dict(wi, pdf, li, target_p,
    target_err, target_n, is_delta, is_env, is_area).
    """
    ltype = light_rows[:, LA_TYPE].to(torch.int32)
    emit = light_rows[:, LA_EMIT]
    lvec = light_rows[:, LA_VEC]
    zero1 = torch.zeros(ref_p.shape[:1], dtype=torch.float32,
                        device=ref_p.device)
    zero3 = torch.zeros_like(ref_p)
    preds, wis, pdfs, lis, targets, terrs, tns = [], [], [], [], [], [], []

    if LIGHT_AREA in light_set:
        ps, ns, perr = _tri_sample(light_rows, u)
        wi_area = pm.normalize(ps - ref_p)
        preds.append(ltype == LIGHT_AREA)
        wis.append(wi_area)
        pdfs.append(_tri_pdf_along_sampled(light_rows, ref_p, ref_err, ref_n,
                                           wi_area))
        # one-sided emission toward the receiver
        lis.append(torch.where((pm.dot(ns, -wi_area) > 0.0)[..., None],
                               emit, 0.0))
        targets.append(ps)
        terrs.append(perr)
        tns.append(ns)

    if LIGHT_POINT in light_set:
        to_l = lvec - ref_p
        dist_sq_p = pm.norm_sq(to_l)
        preds.append(ltype == LIGHT_POINT)
        wis.append(to_l / pm.sqrt(torch.clamp_min(dist_sq_p,
                                                  1e-30))[..., None])
        pdfs.append(torch.ones_like(zero1))
        lis.append(emit / torch.clamp_min(dist_sq_p, 1e-30)[..., None])
        targets.append(lvec.expand(ref_p.shape))
        terrs.append(zero3)
        tns.append(zero3)

    if LIGHT_DISTANT in light_set:
        preds.append(ltype == LIGHT_DISTANT)
        wis.append(lvec)
        pdfs.append(torch.ones_like(zero1))
        lis.append(emit)
        targets.append(ref_p + lvec * (2.0 * scene.world_radius))
        terrs.append(zero3)
        tns.append(zero3)

    if LIGHT_INFINITE in light_set:
        wi_env, pdf_env, li_env = _env_sample_li(scene, u)
        preds.append(ltype == LIGHT_INFINITE)
        wis.append(wi_env)
        pdfs.append(pdf_env)
        lis.append(li_env)
        targets.append(ref_p + wi_env * (2.0 * scene.world_radius))
        terrs.append(zero3)
        tns.append(zero3)

    def sel(vals, default):
        if len(vals) == 1:
            return vals[0]
        if vals[0].dim() == 2:
            return select([p[..., None] for p in preds], vals, default)
        return select(preds, vals, default)

    return dict(wi=sel(wis, wis[0]), pdf=sel(pdfs, zero1),
                li=sel(lis, zero3), target_p=sel(targets, targets[0]),
                target_err=sel(terrs, zero3), target_n=sel(tns, zero3),
                is_delta=(ltype == LIGHT_POINT) | (ltype == LIGHT_DISTANT),
                is_env=ltype == LIGHT_INFINITE, is_area=ltype == LIGHT_AREA)


@_light_span
def pdf_li(scene, light_rows, ref_p, ref_err, ref_n, wi,
           light_set=ALL_LIGHTS):
    """pdf of each ray's chosen light along wi (the MIS BSDF branch).
    Delta lights (point, distant) give 0."""
    ltype = light_rows[:, LA_TYPE].to(torch.int32)
    preds, pdfs = [], []
    if LIGHT_AREA in light_set:
        preds.append(ltype == LIGHT_AREA)
        pdfs.append(_tri_pdf_along_sampled(light_rows, ref_p, ref_err,
                                           ref_n, wi))
    if LIGHT_INFINITE in light_set:
        preds.append(ltype == LIGHT_INFINITE)
        pdfs.append(env_pdf_li(scene, wi))
    zero1 = torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    if not preds:
        return zero1
    if len(preds) == 1 and len(light_set) == 1:
        return pdfs[0]
    return select(preds, pdfs, zero1)


# ---------------------------------------------------------------------------
# Emission sampling: rays leaving the lights (the light tracer's start).
# ---------------------------------------------------------------------------


def _disk_point(scene, axis, u):
    """A point on the world-bound disk facing ``axis`` (unit, (N, 3)),
    one radius out along it: the origin of a ray from a light at
    infinity."""
    v2, v3 = pm.coordinate_system(axis)
    cd = concentric_sample_disk(u)
    p_disk = scene.world_center + scene.world_radius * (
        cd[..., 0:1] * v2 + cd[..., 1:2] * v3)
    return p_disk + scene.world_radius * axis


def power(scene, light_rows, light_set=ALL_LIGHTS):
    """Total emitted power (N, 3) of each light row: area, a one-sided
    Lambert emitter, Le A pi; point, 4 pi I; distant, L pi r^2 over the
    world-bound disk; infinite, pi r^2 times the map's mean radiance."""
    ltype = light_rows[:, LA_TYPE].to(torch.int32)
    emit = light_rows[:, LA_EMIT]
    disk = np.pi * scene.world_radius * scene.world_radius
    preds, vals = [], []
    if LIGHT_AREA in light_set:
        area = _tri_area(light_rows[:, LA_P0], light_rows[:, LA_P1],
                         light_rows[:, LA_P2])
        preds.append(ltype == LIGHT_AREA)
        vals.append(emit * (np.pi * area)[..., None])
    if LIGHT_POINT in light_set:
        preds.append(ltype == LIGHT_POINT)
        vals.append(emit * (4.0 * np.pi))
    if LIGHT_DISTANT in light_set:
        preds.append(ltype == LIGHT_DISTANT)
        vals.append(emit * disk)
    if LIGHT_INFINITE in light_set:
        preds.append(ltype == LIGHT_INFINITE)
        mean_l = torch.where(scene.has_env, scene.env_map.mean((0, 1)), 0.0)
        vals.append((mean_l * disk).expand(emit.shape))
    if len(vals) == 1:
        return vals[0]
    return select([p[..., None] for p in preds], vals, torch.zeros_like(emit))


def sample_le(scene, light_rows, u_pos, u_dir, light_set=ALL_LIGHTS):
    """Sample a ray leaving each row's light (PBRT Sample_Le).

    u_pos / u_dir: (N, 2) uniforms of the position and the direction.
    Returns dict(o (N, 3), d (N, 3) unit, n_light (N, 3), pdf_pos (N,),
    pdf_dir (N,), le (N, 3)); light types outside ``light_set`` are not
    evaluated, as in sample_li.
    """
    ltype = light_rows[:, LA_TYPE].to(torch.int32)
    emit = light_rows[:, LA_EMIT]
    lvec = light_rows[:, LA_VEC]
    n = light_rows.shape[0]
    zero1 = torch.zeros((n,), dtype=torch.float32, device=emit.device)
    zero3 = torch.zeros((n, 3), dtype=torch.float32, device=emit.device)
    inv_disk = 1.0 / (np.pi * scene.world_radius * scene.world_radius)

    preds, os_, ds, nls, ppos, pdir, les = [], [], [], [], [], [], []

    if LIGHT_AREA in light_set:
        # position uniform on the triangle, direction cosine-weighted
        # about the (face-forwarded) emission normal
        ps, ns, perr = _tri_sample(light_rows, u_pos)
        area = _tri_area(light_rows[:, LA_P0], light_rows[:, LA_P1],
                         light_rows[:, LA_P2])
        w_local = cosine_sample_hemisphere(u_dir)
        v2, v3 = pm.coordinate_system(ns)
        d = (w_local[..., 0:1] * v2 + w_local[..., 1:2] * v3
             + w_local[..., 2:3] * ns)
        preds.append(ltype == LIGHT_AREA)
        os_.append(pm.offset_ray_origin(ps, perr, ns, d))
        ds.append(d)
        nls.append(ns)
        ppos.append(1.0 / torch.clamp_min(area, 1e-20))
        pdir.append(w_local[..., 2] * pm.INV_PI)
        les.append(emit)

    if LIGHT_POINT in light_set:
        d = uniform_sample_sphere(u_dir)
        preds.append(ltype == LIGHT_POINT)
        os_.append(lvec.expand(n, 3))
        ds.append(d)
        nls.append(d)
        ppos.append(torch.ones_like(zero1))
        pdir.append(torch.full_like(zero1, 0.25 / np.pi))
        les.append(emit)

    if LIGHT_DISTANT in light_set:
        # lvec points toward the light: emission travels along -lvec
        preds.append(ltype == LIGHT_DISTANT)
        os_.append(_disk_point(scene, lvec, u_pos))
        ds.append(-lvec)
        nls.append(-lvec)
        ppos.append(zero1 + inv_disk)
        pdir.append(torch.ones_like(zero1))
        les.append(emit)

    if LIGHT_INFINITE in light_set:
        wi, pdf_env, le_env = _env_sample_li(scene, u_dir)
        d = -wi
        preds.append(ltype == LIGHT_INFINITE)
        os_.append(_disk_point(scene, wi, u_pos))
        ds.append(d)
        nls.append(d)
        ppos.append(zero1 + inv_disk)
        pdir.append(pdf_env)
        les.append(le_env)

    def sel(vals, default):
        if len(vals) == 1:
            return vals[0]
        if vals[0].dim() == 2:
            return select([p[..., None] for p in preds], vals, default)
        return select(preds, vals, default)

    return dict(o=sel(os_, os_[0]), d=sel(ds, ds[0]),
                n_light=sel(nls, zero3), pdf_pos=sel(ppos, zero1),
                pdf_dir=sel(pdir, zero1), le=sel(les, zero3))


def pdf_le(scene, light_rows, d, n_light, light_set=ALL_LIGHTS):
    """(pdf_pos, pdf_dir) of a ray emitted along d by each row's light
    (PBRT Pdf_Le). Delta positions (point) have pdf_pos 0; delta
    directions (distant) pdf_dir 0."""
    ltype = light_rows[:, LA_TYPE].to(torch.int32)
    zero1 = torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    inv_disk = 1.0 / (np.pi * scene.world_radius * scene.world_radius)
    preds, ppos, pdir = [], [], []
    if LIGHT_AREA in light_set:
        area = _tri_area(light_rows[:, LA_P0], light_rows[:, LA_P1],
                         light_rows[:, LA_P2])
        cos = pm.dot(n_light, d)
        preds.append(ltype == LIGHT_AREA)
        ppos.append(1.0 / torch.clamp_min(area, 1e-20))
        pdir.append(torch.where(cos > 0.0, cos * pm.INV_PI, 0.0))
    if LIGHT_POINT in light_set:
        preds.append(ltype == LIGHT_POINT)
        ppos.append(zero1)
        pdir.append(torch.full_like(zero1, 0.25 / np.pi))
    if LIGHT_DISTANT in light_set:
        preds.append(ltype == LIGHT_DISTANT)
        ppos.append(zero1 + inv_disk)
        pdir.append(zero1)
    if LIGHT_INFINITE in light_set:
        preds.append(ltype == LIGHT_INFINITE)
        ppos.append(zero1 + inv_disk)
        pdir.append(env_pdf_li(scene, -d))
    if len(preds) == 1:
        return ppos[0], pdir[0]
    return select(preds, ppos, zero1), select(preds, pdir, zero1)
