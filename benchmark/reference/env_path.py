"""The reference render of the check's tiles for scenes of diffuse, rough
metal, rough plastic, glass, mirror and rough glass triangles lit by an
environment map alone (``env_scene.py``), in plain PyTorch, float32.

``render_tiles`` renders, as ``sphere_path.render_tiles`` does, every
camera sample of sample frames ``[0, frames)`` whose filter footprint
reaches the check's tiles, a lane a (pixel, frame) pair, and splats it
into a film of its own. The camera rays, the intersection, the vertex,
the first four BSDFs, the roulette and the film are ``sphere_path``'s.
What is new:

**The environment light** (upstream's ``InfiniteAreaLight``, pbrt-v3's
with its ``Distribution2D``). A direction's map coordinates: the world
direction turned into the map's frame and normalised, u = phi / (2 pi)
(phi from atan2, in [0, 2 pi)), v = theta / pi (theta the angle from the
frame's z axis). ``Le`` is the map's bilinear value at (u, v) at its
level 0: texel centres at half-integers, wrapping in u, clamped in v.
The sampling density is pbrt's ``Distribution2D`` over a function of
twice the map's resolution: at the centre of each of its cells the
luminance (0.212671 r + 0.715160 g + 0.072169 b) looked up bilinearly
(clamped at every edge), times sin(theta) of the cell's row. Each row
is a ``Distribution1D``: cdf[0] = 0, cdf[i] = cdf[i - 1] + func[i - 1] /
n in float32 one step after the other, the integral cdf[n], then the cdf
divided by it (a row of integral 0 takes the uniform cdf); the rows'
integrals make the marginal. ``sample_li(u)``: the row from the marginal
by u[1], the column from the row's conditional by u[0], each the last
interval whose cdf is at most u, continued linearly inside it; the
direction at (u, v) turned into the world, the density map_pdf / (2 pi^2
sin(theta)) (0 at sin(theta) = 0), the radiance ``Le`` there.
``pdf_li(w)``: the function at w's cell over the marginal's integral,
over 2 pi^2 sin(theta).

**The BSDFs**, beside ``sphere_path``'s:

- MIRROR: specular reflection, f = 1 / |cos(wi)| (Fresnel 1), pdf 1;
- ROUGHGLASS: pbrt-v3's rough glass, a ``BSDF`` of two lobes:
  ``MicrofacetReflection`` (R = kd, the dielectric Fresnel term) and
  ``MicrofacetTransmission`` (T = ks, radiance transport, the interior
  eta), both over the isotropic Trowbridge-Reitz distribution. Its
  sample picks a lobe by u0 < 1/2, u0 stretched back over the half,
  samples the lobe's visible normal, reflects or refracts about it; then,
  as pbrt's ``BSDF::Sample_f`` does for a non-specular lobe, f is summed
  over the lobes that the geometric normal's test allows (reflection
  where (wi . ng)(wo . ng) > 0, transmission elsewhere) and the density
  averaged over both. Its evaluation for the light's branch is the same
  sum and average.

**The paths** (pbrt-v3's path tracer with pbrt-v4's one-sample MIS and
the one light a vertex): an escaped ray adds the environment's
radiance, at full weight at the camera vertex and after a specular
bounce, else weighted by the power heuristic against the previous
vertex's BSDF density; at each vertex of a non-specular material (all
but MIRROR and GLASS) the light is sampled, its radiance weighted by the
power heuristic against the BSDF's density, and tested by an unbounded
shadow ray from the robust origin along the sampled direction. Russian
roulette as ``sphere_path``'s (``eta_scale`` moves on specular
transmission only, as in pbrt-v3).

**Where the reference follows the port's order of operations**, and why:

- the tables: the luminance is numpy's float32 product of the map with
  the weight vector (``image @ weights``), and the bilinear lookup and the
  sin(theta) factor run in float64 before one rounding to float32; the
  rotation into the world is the importer's double-precision Euler
  product rounded to float32, and its inverse numpy's float32 inverse of
  that. The search of a cdf turns on its last bit (a u that lands on a
  cdf entry picks the next cell), and a level direction's row turns on
  the rotation's rounding, so the tables are held to the port's bit for
  bit, each step where its rounding is not forced;
- the map coordinates and the sampled direction take each product in the
  port's order (u * 2 * pi as (u * 2) * pi, the scalars rounded to
  float32), so a lookup and a pdf cell land where the port's do;
- ROUGHGLASS: the reflection lobe's Fresnel term is taken at wi . wh with
  wh as normalised (not first turned to the normal's side), and the
  averaged density recomputes each lobe's density from wi (the reflection
  lobe's half vector normalize(wo + wi), not the sampled one), as the
  JAX package and the port do; each product and root in the port's
  order, so that beta, and the roulette on it, round alike;
- the rest is ``sphere_path``'s, whose docstring says why.

Each bounce ``b`` draws its numbers from the Sobol dimensions ``2 + 8b``
on: the light's direction (+0, +1), the BSDF (+5, +6) and the roulette
(+7); with one light no number picks it.

The control, ``control=torch.bfloat16``, rounds the camera rays, each
bounce's state and the film's terms to that precision.
"""

from __future__ import annotations

import numpy as np
import torch

from . import diffuse_path as dp
from . import env_scene, sobol
from . import sphere_path as sp
from .env_scene import MIRROR, ROUGHGLASS
from .sphere_path import DIMS_PER_BOUNCE, RR_START_DEPTH, WAVE_LANES
from .sphere_scene import GLASS

LUMINANCE = np.asarray([0.212671, 0.715160, 0.072169], np.float32)
INV_PI = float(np.float32(1.0 / np.pi))
INV_2PI = float(np.float32(0.5 / np.pi))
TWO_PI_SQ = 2.0 * np.pi * np.pi


# ------------------------------------------------------- pbrt's tables
def distribution_1d(f: np.ndarray):
    """pbrt-v3's ``Distribution1D`` of each row of ``f`` (..., n),
    float32: (func, cdf (..., n + 1), integral (...))."""
    f = np.asarray(f, np.float32)
    n = f.shape[-1]
    cdf = np.zeros(f.shape[:-1] + (n + 1,), np.float32)
    step = f / np.float32(n)
    for i in range(1, n + 1):
        cdf[..., i] = cdf[..., i - 1] + step[..., i - 1]
    total = cdf[..., n].copy()
    flat = total == 0.0
    uniform = np.arange(n + 1, dtype=np.float32) / np.float32(n)
    cdf = np.where(flat[..., None], uniform,
                   cdf / np.where(flat, np.float32(1.0), total)[..., None])
    return f, cdf.astype(np.float32), total


def importance(image: np.ndarray) -> np.ndarray:
    """The (2H, 2W) float32 function the environment is sampled by
    (module text)."""
    lum = np.asarray(image, np.float32) @ LUMINANCE
    h, w = lum.shape
    rows, cols = 2 * h, 2 * w
    v = (np.arange(rows) + 0.5) / rows
    u = (np.arange(cols) + 0.5) / cols
    y, x = v * h - 0.5, u * w - 0.5
    y0, x0 = np.floor(y).astype(np.int64), np.floor(x).astype(np.int64)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    ya, yb = np.clip(y0, 0, h - 1)[:, None], np.clip(y0 + 1, 0, h - 1)[:, None]
    xa, xb = np.clip(x0, 0, w - 1)[None, :], np.clip(x0 + 1, 0, w - 1)[None, :]
    top = lum[ya, xa] * (1 - fx) + lum[ya, xb] * fx
    bottom = lum[yb, xa] * (1 - fx) + lum[yb, xb] * fx
    sin_theta = np.sin(np.pi * v)[:, None]
    return ((top * (1 - fy) + bottom * fy) * sin_theta).astype(np.float32)


def tables(image: np.ndarray) -> dict:
    """pbrt-v3's ``Distribution2D`` of ``importance(image)``, as host
    arrays: the rows' func, cdf and integrals, the marginal's."""
    func, cdf, total = distribution_1d(importance(image))
    m_func, m_cdf, m_total = distribution_1d(total)
    return dict(cond_func=func, cond_cdf=cdf, cond_int=total,
                marg_func=m_func, marg_cdf=m_cdf, marg_int=m_total)


def _continuous(cdf, func, total, lo, u):
    """pbrt's ``SampleContinuous`` past the search: the cell ``lo`` of
    each lane's row (cdf (N, n + 1) rows, func (N, n), total (N,)) and
    u's place in it: (x in [0, 1), density)."""
    n = func.shape[-1]
    c0 = cdf.gather(-1, lo[:, None])[:, 0]
    c1 = cdf.gather(-1, lo[:, None] + 1)[:, 0]
    width = c1 - c0
    du = torch.where(width > 0.0,
                     (u - c0) / torch.where(width > 0.0, width, 1.0), u - c0)
    val = func.gather(-1, lo[:, None])[:, 0]
    pdf = torch.where(total > 0.0, val / torch.clamp_min(total, 1e-30), 0.0)
    return (lo.to(torch.float32) + du) / n, pdf


# -------------------------------------------------------- the environment
class Environment:
    """The map, its tables and its rotation on the device."""

    def __init__(self, env: dict, device):
        def t(a):
            return torch.as_tensor(np.array(a), device=device)

        self.image = t(np.asarray(env["image"], np.float32))
        for key, val in tables(env["image"]).items():
            setattr(self, key, t(val))
        l2w = np.asarray(env["l2w"], np.float64).astype(np.float32)
        self.l2w = t(l2w)
        self.w2l = t(np.linalg.inv(l2w).astype(np.float32))
        nv = self.cond_func.shape[0]
        # every row's cdf, each shifted by its row number, in one sorted
        # float64 row: the shift is exact, so a search of u + v in it is a
        # search of u in row v alone
        self.flat_cdf = (self.cond_cdf.double()
                         + torch.arange(nv, device=device,
                                        dtype=torch.float64)[:, None]
                         ).reshape(-1).contiguous()

    @staticmethod
    def _turn(m, w):
        """m @ w for each row of w (N, 3), the columns summed in order."""
        return w[:, 0:1] * m[:, 0] + w[:, 1:2] * m[:, 1] + \
            w[:, 2:3] * m[:, 2]

    def uv(self, d):
        """The map coordinates (N, 2) of world directions."""
        w = sp.normalize(self._turn(self.w2l, d))
        phi = torch.atan2(w[:, 1], w[:, 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * np.pi, phi)
        theta = torch.arccos(torch.clamp(w[:, 2], -1.0, 1.0))
        return torch.stack([phi * INV_2PI, theta * INV_PI], -1), theta

    def lookup(self, uv):
        """The map's bilinear radiance at uv (N, 2)."""
        h, w = self.image.shape[:2]
        x = uv[:, 0] * w - 0.5
        y = uv[:, 1] * h - 0.5
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        fx = (x - x0.to(torch.float32))[:, None]
        fy = (y - y0.to(torch.float32))[:, None]
        xa, xb = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
        ya, yb = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
        img = self.image
        top = img[ya, xa] * (1 - fx) + img[ya, xb] * fx
        bottom = img[yb, xa] * (1 - fx) + img[yb, xb] * fx
        return top * (1 - fy) + bottom * fy

    def le(self, d):
        return self.lookup(self.uv(d)[0])

    def pdf_li(self, d):
        """Solid-angle density of ``sample_li``'s direction d."""
        uv, theta = self.uv(d)
        sin_t = torch.sin(theta)
        nv, nu = self.cond_func.shape
        iu = torch.clamp((uv[:, 0] * nu).long(), 0, nu - 1)
        iv = torch.clamp((uv[:, 1] * nv).long(), 0, nv - 1)
        cell = self.cond_func[iv, iu] / torch.clamp_min(self.marg_int, 1e-30)
        pdf = cell / (TWO_PI_SQ * torch.clamp_min(sin_t, 1e-20))
        return torch.where(sin_t == 0.0, 0.0, pdf)

    def sample_li(self, u):
        """(wi, pdf, radiance) of a direction drawn by u (N, 2)."""
        nv, nu = self.cond_func.shape
        u0, u1 = u[:, 0].contiguous(), u[:, 1].contiguous()
        row = torch.clamp(torch.searchsorted(self.marg_cdf, u1, right=True)
                          - 1, 0, nv - 1)
        v, pdf_v = _continuous(self.marg_cdf[None].expand(len(u1), -1),
                               self.marg_func[None].expand(len(u1), -1),
                               self.marg_int.expand(len(u1)), row, u1)
        key = u0.double() + row.double()
        col = torch.searchsorted(self.flat_cdf, key, right=True) \
            - row * (nu + 1) - 1
        col = torch.clamp(col, 0, nu - 1)
        uu, pdf_u = _continuous(self.cond_cdf[row], self.cond_func[row],
                                self.cond_int[row], col, u0)
        map_pdf = pdf_u * pdf_v
        uv = torch.stack([uu, v], -1)
        theta = uv[:, 1] * np.pi
        phi = uv[:, 0] * 2.0 * np.pi
        sin_t = torch.sin(theta)
        local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                             torch.cos(theta)], -1)
        wi = self._turn(self.l2w, local)
        pdf = torch.where(sin_t == 0.0, 0.0,
                          map_pdf / (TWO_PI_SQ * torch.clamp_min(sin_t,
                                                                 1e-20)))
        ok = map_pdf > 0.0
        return wi, torch.where(ok, pdf, 0.0), \
            torch.where(ok[:, None], self.lookup(uv), 0.0)


# ------------------------------------------------------------ rough glass
def _fresnel_dielectric(eta):
    return lambda c: sp.fr_dielectric(c, eta)[:, None]


def _reflection_f(r, wo, wi, a, fresnel):
    """``MicrofacetReflection::f``."""
    cto, cti = torch.abs(wo[:, 2]), torch.abs(wi[:, 2])
    wh = wi + wo
    whn = sp.normalize(wh)
    val = r * sp.tr_d(whn, a)[:, None] * sp.tr_g(wo, wi, a)[:, None] * \
        fresnel(sp.dot(wi, whn)) / torch.clamp_min(4.0 * cti * cto,
                                                   1e-20)[:, None]
    ok = (sp.dot(wh, wh) > 0.0) & (cti > 0.0) & (cto > 0.0)
    return torch.where(ok[:, None], val, 0.0)


def _transmission_f(t, wo, wi, a, eta_b):
    """``MicrofacetTransmission::f`` in radiance transport; eta_b the
    interior's index (the outside's 1)."""
    cto, cti = torch.abs(wo[:, 2]), torch.abs(wi[:, 2])
    eta = torch.where(wo[:, 2] > 0.0, eta_b, 1.0 / eta_b)
    wh = wo + wi * eta[:, None]
    whn = sp.normalize(wh)
    whn = torch.where((whn[:, 2] < 0.0)[:, None], -whn, whn)
    d_o, d_i = sp.dot(wo, whn), sp.dot(wi, whn)
    fr = sp.fr_dielectric(d_o, eta_b)
    denom = d_o + eta * d_i
    factor = 1.0 / eta
    val = (1.0 - fr)[:, None] * t * torch.abs(
        sp.tr_d(whn, a) * sp.tr_g(wo, wi, a) * eta * eta * torch.abs(d_i)
        * torch.abs(d_o) * factor * factor
        / torch.clamp_min(cti * cto * denom * denom, 1e-20))[:, None]
    ok = ~sp.same_hemisphere(wo, wi) & (cti > 0.0) & (cto > 0.0) & \
        ~(d_o * d_i > 0.0) & (sp.dot(wh, wh) > 0.0)
    return torch.where(ok[:, None], val, 0.0)


def _transmission_pdf(wo, wi, a, eta_b):
    """``MicrofacetTransmission::Pdf``: the visible normal's density
    times |d wh / d wi|."""
    eta = torch.where(wo[:, 2] > 0.0, eta_b, 1.0 / eta_b)
    wh_raw = wo + wi * eta[:, None]
    wh = sp.normalize(wh_raw)
    d_o, d_i = sp.dot(wo, wh), sp.dot(wi, wh)
    denom = d_o + eta * d_i
    jacobian = torch.abs(eta * eta * d_i
                         / torch.clamp_min(denom * denom, 1e-20))
    ok = (sp.dot(wh_raw, wh_raw) > 0.0) & ~sp.same_hemisphere(wo, wi) & \
        ~(d_o * d_i > 0.0)
    return torch.where(ok, sp.tr_pdf(wo, wh, a) * jacobian, 0.0)


def rough_glass(m, wo, wi, reflect_ng):
    """f (the lobes the geometric normal allows) and the density averaged
    over both lobes, at local (wo, wi)."""
    a, eta_b = m["alpha"], m["eta"][:, 0]
    f = torch.where(reflect_ng[:, None],
                    _reflection_f(m["kd"], wo, wi, a,
                                  _fresnel_dielectric(eta_b)),
                    _transmission_f(m["ks"], wo, wi, a, eta_b))
    pdf = 0.5 * (sp.metal_pdf(wo, wi, a) + _transmission_pdf(wo, wi, a,
                                                             eta_b))
    return f, pdf


def refract(w, n, eta):
    """pbrt's ``Refract`` of w about n at the relative index eta: (wt,
    ok), ok False under total internal reflection."""
    cos_i = sp.dot(n, w)
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    cos_t = sp.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    return eta[:, None] * -w + (eta * cos_i - cos_t)[:, None] * n, \
        sin2_t < 1.0


def sample_rough_glass(m, wo, u, reflect_ng_fn):
    """pbrt's ``BSDF::Sample_f`` over the two lobes (module text):
    (wi, f, pdf, transmission)."""
    a, eta_b = m["alpha"], m["eta"][:, 0]
    first = u[:, 0] < 0.5
    us = torch.stack([sp._stretch_half(u[:, 0], first), u[:, 1]], -1)
    wh = sp.tr_sample_wh(wo, us, a)
    facing = sp.dot(wo, wh)
    wi_r = sp.reflect(wo, wh)
    ratio = torch.where(wo[:, 2] > 0.0, 1.0 / eta_b, eta_b)
    wi_t, refracts = refract(wo, torch.where((facing < 0.0)[:, None], -wh,
                                             wh), ratio)
    wi = torch.where(first[:, None], wi_r, wi_t)
    ok = (facing >= 0.0) & (wo[:, 2] != 0.0) & \
        torch.where(first, sp.same_hemisphere(wo, wi_r), refracts)
    reflect_ng = reflect_ng_fn(wi)
    f, pdf = rough_glass(m, wo, wi, reflect_ng)
    return wi, torch.where(ok[:, None], f, 0.0), torch.where(ok, pdf, 0.0), \
        ~reflect_ng


# -------------------------------------------------------------- the BSDFs
def eval_f_pdf(m, wo, wi, reflect_ng):
    """``sphere_path.eval_f_pdf`` with ROUGHGLASS; zero for MIRROR."""
    f, pdf = sp.eval_f_pdf(m, wo, wi, reflect_ng)
    rough = m["mtype"] == ROUGHGLASS
    f_rg, pdf_rg = rough_glass(m, wo, wi, reflect_ng)
    wo_ok = wo[:, 2] != 0.0
    return (torch.where(rough[:, None], torch.where(wo_ok[:, None], f_rg,
                                                    0.0), f),
            torch.where(rough, torch.where(wo_ok, pdf_rg, 0.0), pdf))


def sample_f(m, wo, u, reflect_ng_fn):
    """``sphere_path.sample_f`` with MIRROR and ROUGHGLASS: dict(wi, f,
    pdf, specular, transmission)."""
    bs = sp.sample_f(m, wo, u)
    mtype = m["mtype"]
    mirror, rough = mtype == MIRROR, mtype == ROUGHGLASS
    wi_m = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    f_m = torch.ones_like(m["kd"]) / torch.clamp_min(
        torch.abs(wi_m[:, 2]), 1e-20)[:, None]
    wi_g, f_g, pdf_g, trans_g = sample_rough_glass(m, wo, u, reflect_ng_fn)
    return dict(
        wi=torch.where(mirror[:, None], wi_m,
                       torch.where(rough[:, None], wi_g, bs["wi"])),
        f=torch.where(mirror[:, None], f_m,
                      torch.where(rough[:, None], f_g, bs["f"])),
        pdf=torch.where(mirror, 1.0, torch.where(rough, pdf_g, bs["pdf"])),
        specular=bs["specular"] | mirror,
        transmission=torch.where(rough, trans_g, bs["transmission"]))


# ------------------------------------------------------------------ paths
def trace(scene: sp.Scene, env: Environment, draws: sobol.Draws, o, d,
          max_depth: int, q):
    """Radiance of each lane's path from the camera ray (o, d)."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    big_l = torch.zeros((n, 3), dtype=f32, device=dev)
    lane = torch.arange(n, device=dev)  # the wave's lanes still running
    beta = torch.ones((n, 3), dtype=f32, device=dev)
    eta_scale = torch.ones((n,), dtype=f32, device=dev)
    specular = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), dtype=f32, device=dev)
    for bounce in range(max_depth + 1):
        if lane.numel() == 0:
            break
        base = 2 + DIMS_PER_BOUNCE * bounce
        dr = sobol.Draws(draws.index[lane], draws.scramble[lane])
        hit, tri, b = scene.closest(o, d)

        # the environment, seen by the rays that escape
        le = env.le(d)
        if bounce == 0:
            w_env = torch.ones_like(prev_pdf)
        else:
            w_env = torch.where(specular, 1.0, dp.power_heuristic(
                prev_pdf, env.pdf_li(d)))
        big_l[lane] = q(big_l[lane] + torch.where(
            (~hit)[:, None], beta * le * w_env[:, None], 0.0))
        if bounce == max_depth:
            break

        v = sp.vertex(scene, tri, b)
        v["p"], v["err"] = q(v["p"]), q(v["err"])
        m = scene.material(tri)
        wo = -d
        wo_l = sp.to_local(v, wo)

        # the light's branch at the non-specular vertices
        wi, lpdf, li = env.sample_li(dr.two(base + 0))
        reflect_ng = sp.dot(wi, v["ng"]) * sp.dot(wo, v["ng"]) > 0.0
        f, scatter_pdf = eval_f_pdf(m, wo_l, sp.to_local(v, wi), reflect_ng)
        f = f * torch.abs(sp.dot(wi, v["ns"]))[:, None]
        useful = (m["mtype"] != GLASS) & (m["mtype"] != MIRROR) & hit & \
            (lpdf > 0.0) & (li != 0.0).any(-1) & (f != 0.0).any(-1)
        contrib = f * li * dp.power_heuristic(lpdf, scatter_pdf)[:, None] \
            / torch.clamp_min(lpdf, 1e-20)[:, None]
        ask = torch.nonzero(useful)[:, 0]
        so = sp.offset_origin(v["p"][ask], v["err"][ask], v["ng"][ask],
                              wi[ask])
        lit = torch.zeros_like(useful)
        lit[ask] = ~scene.occluded(so, wi[ask], torch.full(
            (ask.numel(),), float("inf"), dtype=f32, device=dev))
        big_l[lane] = q(big_l[lane] + torch.where(lit[:, None],
                                                  beta * contrib, 0.0))

        # the next direction, by the BSDF
        def reflect_ng_fn(w_local):
            return sp.dot(dp.to_world(v, w_local), v["ng"]) * \
                sp.dot(wo, v["ng"]) > 0.0

        bs = sample_f(m, wo_l, dr.two(base + 5), reflect_ng_fn)
        wi = dp.to_world(v, bs["wi"])
        dead = (bs["f"] == 0.0).all(-1) | (bs["pdf"] == 0.0)
        go = hit & ~dead
        new_beta = beta * bs["f"] * (
            torch.abs(sp.dot(wi, v["ns"]))
            / torch.clamp_min(bs["pdf"], 1e-20))[:, None]
        beta = q(torch.where(go[:, None], new_beta, beta))
        specular = torch.where(go, bs["specular"], specular)
        prev_pdf = torch.where(go, bs["pdf"], prev_pdf)
        eta = m["eta"][:, 0]
        eta_scale = torch.where(
            go & bs["specular"] & bs["transmission"],
            eta_scale * torch.where(sp.dot(wo, v["ng"]) > 0.0, eta * eta,
                                    1.0 / torch.clamp_min(eta * eta, 1e-20)),
            eta_scale)
        o = q(torch.where(go[:, None],
                          sp.offset_origin(v["p"], v["err"], v["ng"], wi), o))
        d = q(torch.where(go[:, None], wi, d))

        if bounce > RR_START_DEPTH:
            mx = (beta * eta_scale[:, None]).max(-1).values
            gate = go & (mx < 1.0)
            q_rr = torch.clamp_min(1.0 - mx, 0.05)
            kill = gate & (dr.one(base + 7) < q_rr)
            beta = q(torch.where((gate & ~kill)[:, None],
                                 beta / (1.0 - q_rr)[:, None], beta))
            go = go & ~kill

        keep = torch.nonzero(go)[:, 0]
        lane, o, d, beta, eta_scale, specular, prev_pdf = (
            x[keep] for x in (lane, o, d, beta, eta_scale, specular,
                              prev_pdf))
    return torch.where(torch.isfinite(big_l), big_l, 0.0)


# ------------------------------------------------------------ the tiles
def render_tiles(config: dict, traffic: dict, camera: dict, tiles,
                 frames: int, device, control=None) -> torch.Tensor:
    """The (H, W, 4) film of frames ``[0, frames)`` at the tiles (top-left
    corners, ``traffic["check"]["tile_px"]`` a side) and nowhere else."""
    if (traffic["sampler"], traffic["mis_mode"],
            traffic["light_strategy"]) != ("sobol", "onesample", "one"):
        raise ValueError("the reference renders Sobol, one-sample MIS and "
                         "one light a vertex")
    if config["scene"]["loader"] != "mitsuba":
        raise ValueError("the reference reads Mitsuba scenes")

    def q(x):
        return x if control is None else x.to(control).to(torch.float32)

    dev = torch.device(device)
    tris = env_scene.load(config["scene"]["path"])
    env = Environment(tris.pop("env"), dev)
    scene = sp.Scene(tris, dev)
    w, h = traffic["resolution"]
    px, py = dp.sample_pixels(tiles, traffic["check"]["tile_px"], (w, h))
    domain = sobol.Domain(*dp.sample_rect(w, h))
    scramble = domain.scramble(px, py)
    row = torch.as_tensor(dp.filter_row(), device=dev)
    film = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    lane_px = np.tile(np.arange(len(px)), frames)
    lane_fr = np.repeat(np.arange(frames), len(px))
    scale = float(domain.resolution)
    off_x, off_y = (float(v) for v in domain.p_min)
    for lo in range(0, len(lane_px), WAVE_LANES):
        lp = lane_px[lo:lo + WAVE_LANES]
        fr = lane_fr[lo:lo + WAVE_LANES]
        index = domain.index(px[lp], py[lp], fr)
        draws = sobol.Draws(torch.as_tensor(index, device=dev),
                            torch.as_tensor(scramble[lp], device=dev))
        pxi = torch.as_tensor(px[lp], device=dev)
        pyi = torch.as_tensor(py[lp], device=dev)
        pxf, pyf = pxi.to(torch.float32), pyi.to(torch.float32)
        jx = torch.clamp(draws.raw(0, scrambled=False) * scale + off_x - pxf,
                         0.0, sobol.ONE_MINUS_EPSILON)
        jy = torch.clamp(draws.raw(1, scrambled=False) * scale + off_y - pyf,
                         0.0, sobol.ONE_MINUS_EPSILON)
        o, d = sp.camera_rays(camera, (w, h), pxf + jx, pyf + jy)
        radiance = trace(scene, env, draws, q(o), q(d),
                         traffic["max_depth"], q)
        dp.splat(film, q(radiance), pxi, pyi, jx, jy, row, q)
    return q(film)
