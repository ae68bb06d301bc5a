"""The reference render of the check's tiles for scenes of diffuse, rough
metal, rough plastic and glass triangles lit by triangle area lights
(``sphere_scene.py``), in plain PyTorch, float32.

``render_tiles`` renders, as ``diffuse_path.render_tiles`` does, every
camera sample of sample frames ``[0, frames)`` whose filter footprint
reaches the check's tiles, a lane a (pixel, frame) pair, and splats it
into a film of its own. The watertight brute-force intersection against
every triangle, the light sampling and the film are ``diffuse_path``'s;
the camera rays, the vertex and its shading frame are made as there,
with every dot product, cross product, norm and root taken as the
functions here take them (a knife edge, below, makes their last bit
count). What a lane does is pbrt-v3's path tracer with pbrt-v4's
one-sample MIS (``mis_mode: onesample``) and one light a vertex, with
these BSDFs (pbrt-v3's, in the local shading frame):

- MATTE: Lambertian, cosine-weighted by Shirley's concentric map;
- METAL: ``MicrofacetReflection`` with the isotropic Trowbridge-Reitz
  distribution (its visible-normal sampling, ``TrowbridgeReitzSample``
  with the slope sampling of its unit form) and ``FresnelConductor``
  (eta, k against air), scaled by ks;
- SUBSTRATE: Ashikhmin and Shirley's ``FresnelBlend`` (kd, ks = r0) over
  the same distribution: u0 below 1/2 picks the cosine lobe, else the
  visible normal's reflection, u0 stretched back over the half;
- GLASS: ``FresnelSpecular``: reflection where u0 < the dielectric
  Fresnel term, else refraction into (or out of) the interior eta, its
  radiance scaled by (eta_i / eta_t)^2.

At each vertex: emission, MIS-weighted by the power heuristic against
the light-sampling density of the vertex before, and at full weight at
the camera vertex and after a specular (GLASS) bounce; light sampling
(one light chosen uniformly, a point on it, a shadow ray) at vertices of
MATTE, METAL and SUBSTRATE only, weighted against the BSDF's density;
the next direction by the BSDF. Where a pbrt BSDF divides by zero the
denominators are held at 1e-20 (1e-30 in the heuristic), and the
azimuth of a direction on the pole reads cos = sin = 1, as in the JAX
package. Russian roulette past depth 3 on m = max(beta * eta_scale),
eta_scale the product of eta^2 (1 / eta^2 leaving) over the specular
transmissions, q = max(0.05, 1 - m). A lane that survives the roulette
leaves it with m = 1 up to rounding, and a specular bounce keeps m there,
so whether the next roulette is played at all turns on the last bit of
beta: the arithmetic here rounds as the JAX package's does. A lane is
dropped from the wave once its path ends.

Each bounce ``b`` draws its numbers from the Sobol dimensions ``2 + 8b``
on: the light point (+0, +1), the light's choice (+4), the BSDF (+5,
+6) and the roulette (+7).

The control, ``control=torch.bfloat16``, rounds the camera rays, each
bounce's state and the film's terms to that precision.
"""

from __future__ import annotations

import numpy as np
import torch

from . import diffuse_path as dp
from . import sobol, sphere_scene
from .sphere_scene import GLASS, MATTE, METAL, SUBSTRATE

WAVE_LANES = 1 << 17
DIMS_PER_BOUNCE = 8
RR_START_DEPTH = 3
INV_PI = dp.INV_PI
FLIP_Z = (1.0, 1.0, -1.0)


# --------------------------------------------------------------- vectors
def sqrt(x):
    """The correctly rounded float32 root: PyTorch's CUDA kernel gives it,
    its CPU kernel misses it by an ulp on some inputs, so there the root
    is taken in float64 and rounded once."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def normalize(v):
    return v / torch.clamp_min(sqrt(dot(v, v)), 1e-20)[:, None]


def cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def same_hemisphere(a, b):
    return a[:, 2] * b[:, 2] > 0.0


def reflect(wo, n):
    """wo mirrored about n."""
    return -wo + 2.0 * dot(wo, n)[:, None] * n


def flip_to(wi, wo):
    """wi turned into wo's hemisphere."""
    return torch.where((wo[:, 2] < 0.0)[:, None], wi * wi.new_tensor(FLIP_Z),
                       wi)


# ---------------------------------------------------------------- Fresnel
def fr_dielectric(cos_i, eta):
    """Unpolarised Fresnel reflectance between air and ``eta``, from
    either side (cos_i > 0: arriving from the air)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, 1.0, eta)
    et = torch.where(entering, eta, 1.0)
    ci = torch.abs(cos_i)
    sin_i = sqrt(torch.clamp_min(1.0 - ci * ci, 0.0))
    sin_t = ei / et * sin_i
    ct = sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp_min(et * ci + ei * ct, 1e-20)
    r_perp = (ei * ci - et * ct) / torch.clamp_min(ei * ci + et * ct, 1e-20)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(sin_t >= 1.0, 1.0, fr)


def fr_conductor(cos_i, eta, k):
    """pbrt-v3's ``FrConductor`` against air: rgb (N, 3)."""
    ci = torch.clamp(cos_i, -1.0, 1.0)[:, None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = sqrt(torch.clamp_min(t0 * t0 + 4.0 * eta2 * k2, 0.0))
    t1 = a2b2 + ci2
    a = sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * ci * a
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-20)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-20)
    return 0.5 * (rp + rs)


# ------------------------------------------- Trowbridge-Reitz, isotropic
def _cos_sin_phi(w, sin_t):
    inv = 1.0 / torch.clamp_min(sin_t, 1e-20)
    pole = sin_t == 0.0
    return (torch.where(pole, 1.0, torch.clamp(w[:, 0] * inv, -1.0, 1.0)),
            torch.where(pole, 1.0, torch.clamp(w[:, 1] * inv, -1.0, 1.0)))


def tr_d(wh, a):
    """The distribution D(wh) of roughness alpha ``a`` (N,)."""
    c2 = wh[:, 2] * wh[:, 2]
    s2 = torch.clamp_min(1.0 - c2, 0.0)
    tan2 = s2 / torch.clamp_min(c2, 1e-20)
    cphi, sphi = _cos_sin_phi(wh, sqrt(s2))
    e = (cphi * cphi / (a * a) + sphi * sphi / (a * a)) * tan2
    d = 1.0 / (np.pi * a * a * (c2 * c2) * (1.0 + e) * (1.0 + e))
    return torch.where(c2 > 0.0, d, 0.0)


def tr_lambda(w, a):
    """Smith's Lambda(w)."""
    c2 = w[:, 2] * w[:, 2]
    s2 = torch.clamp_min(1.0 - c2, 0.0)
    abs_tan = sqrt(s2) / torch.clamp_min(torch.abs(w[:, 2]), 1e-20)
    cphi, sphi = _cos_sin_phi(w, sqrt(s2))
    alpha = sqrt(cphi * cphi * a * a + sphi * sphi * a * a)
    a2t2 = (alpha * abs_tan) * (alpha * abs_tan)
    return torch.where(c2 > 0.0, (-1.0 + sqrt(1.0 + a2t2)) / 2.0, 0.0)


def tr_g1(w, a):
    return 1.0 / (1.0 + tr_lambda(w, a))


def tr_g(wo, wi, a):
    return 1.0 / (1.0 + tr_lambda(wo, a) + tr_lambda(wi, a))


def _slopes(cos_t, u1, u2):
    """pbrt-v3's ``TrowbridgeReitzSample11``: slopes of a visible normal
    of the unit distribution seen at cos_t."""
    r = sqrt(torch.clamp_min(u1 / torch.clamp_min(1.0 - u1, 1e-20), 0.0))
    phi = 2.0 * np.pi * u2
    sx_pole, sy_pole = r * torch.cos(phi), r * torch.sin(phi)
    ct = torch.clamp(cos_t, 1e-6, 0.9999)
    tan_t = sqrt(torch.clamp_min(1.0 - ct * ct, 0.0)) / ct
    inv_a = 1.0 / tan_t
    g1 = 2.0 / (1.0 + sqrt(1.0 + 1.0 / (inv_a * inv_a)))
    big_a = 2.0 * u1 / g1 - 1.0
    denom = big_a * big_a - 1.0
    tmp = torch.where(denom == 0.0, 1e10,
                      1.0 / torch.where(denom == 0.0, 1.0, denom))
    tmp = torch.clamp_max(tmp, 1e10)
    b = tan_t
    disc = sqrt(torch.clamp_min(b * b * tmp * tmp - (big_a * big_a - b * b)
                                * tmp, 0.0))
    sx1, sx2 = b * tmp - disc, b * tmp + disc
    sx = torch.where((big_a < 0.0) | (sx2 > 1.0 / tan_t), sx1, sx2)
    upper = u2 > 0.5
    s = torch.where(upper, 1.0, -1.0)
    v = torch.where(upper, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = (v * (v * (v * 0.27385 - 0.73369) + 0.46341)) / \
        (v * (v * (v * 0.093073 + 0.309420) - 1.000000) + 0.597999)
    sy = s * z * sqrt(1.0 + sx * sx)
    pole = cos_t > 0.9999
    return torch.where(pole, sx_pole, sx), torch.where(pole, sy_pole, sy)


def tr_sample_wh(wo, u, a):
    """A visible microfacet normal for wo (pbrt-v3's ``Sample_wh`` with
    ``sampleVisibleArea``): stretch, sample the slopes, rotate, unstretch."""
    flip = wo[:, 2] < 0.0
    w = torch.where(flip[:, None], -wo, wo)
    ws = normalize(torch.stack([a * w[:, 0], a * w[:, 1], w[:, 2]], -1))
    sx, sy = _slopes(ws[:, 2], u[:, 0], u[:, 1])
    cphi, sphi = _cos_sin_phi(
        ws, sqrt(torch.clamp_min(1.0 - ws[:, 2] * ws[:, 2], 0.0)))
    sx, sy = cphi * sx - sphi * sy, sphi * sx + cphi * sy
    wh = normalize(torch.stack([-(a * sx), -(a * sy), torch.ones_like(sx)],
                               -1))
    return torch.where(flip[:, None], -wh, wh)


def tr_pdf(wo, wh, a):
    """The density of ``tr_sample_wh``'s wh."""
    return tr_d(wh, a) * tr_g1(wo, a) * torch.abs(dot(wo, wh)) / \
        torch.clamp_min(torch.abs(wo[:, 2]), 1e-20)


# --------------------------------------------------------------- the BSDFs
def cosine_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), torch.abs(wi[:, 2]) * INV_PI,
                       0.0)


def metal_f(m, wo, wi):
    """``MicrofacetReflection::f`` with the conductor's Fresnel term."""
    a = m["alpha"]
    cto, cti = torch.abs(wo[:, 2]), torch.abs(wi[:, 2])
    wh = wi + wo
    whn = normalize(wh)
    fr = fr_conductor(torch.abs(dot(wi, whn)), m["eta"], m["k"])
    val = m["ks"] * tr_d(whn, a)[:, None] * tr_g(wo, wi, a)[:, None] * fr / \
        torch.clamp_min(4.0 * cti * cto, 1e-20)[:, None]
    ok = (dot(wh, wh) > 0.0) & (cti > 0.0) & (cto > 0.0)
    return torch.where(ok[:, None], val, 0.0)


def metal_pdf(wo, wi, a):
    wh = normalize(wo + wi)
    pdf = tr_pdf(wo, wh, a) / torch.clamp_min(4.0 * dot(wo, wh), 1e-20)
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def _pow5(v):
    return (v * v) * (v * v) * v


def substrate_f(m, wo, wi):
    """``FresnelBlend::f``."""
    rd, rs, a = m["kd"], m["ks"], m["alpha"]
    cti, cto = torch.abs(wi[:, 2]), torch.abs(wo[:, 2])
    diffuse = (28.0 / (23.0 * np.pi)) * rd * (1.0 - rs) * \
        (1.0 - _pow5(1.0 - 0.5 * cti))[:, None] * \
        (1.0 - _pow5(1.0 - 0.5 * cto))[:, None]
    wh = wi + wo
    whn = normalize(wh)
    schlick = rs + _pow5(1.0 - dot(wi, whn))[:, None] * (1.0 - rs)
    spec = (tr_d(whn, a) /
            torch.clamp_min(4.0 * torch.abs(dot(wi, whn))
                            * torch.maximum(cti, cto), 1e-20))[:, None] \
        * schlick
    return torch.where((dot(wh, wh) > 0.0)[:, None], diffuse + spec, 0.0)


def substrate_pdf(wo, wi, a):
    wh = normalize(wo + wi)
    pdf = 0.5 * (torch.abs(wi[:, 2]) * INV_PI
                 + tr_pdf(wo, wh, a) / torch.clamp_min(4.0 * dot(wo, wh),
                                                       1e-20))
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def _select(mtype, by_type: dict, shape):
    """Each lane's value of its material's entry (zeros for a material
    without one)."""
    out = torch.zeros(shape, dtype=torch.float32, device=mtype.device)
    for kind, value in by_type.items():
        pick = mtype == kind
        out = torch.where(pick[:, None] if out.dim() == 2 else pick, value,
                          out)
    return out


def eval_f_pdf(m, wo, wi, reflect_ng):
    """The non-specular BSDFs' f and density at (wo, wi), local; zero
    where the geometric normal says wi does not reflect, and for GLASS."""
    a = m["alpha"]
    f = _select(m["mtype"], {MATTE: m["kd"] * INV_PI,
                             METAL: metal_f(m, wo, wi),
                             SUBSTRATE: substrate_f(m, wo, wi)}, wo.shape)
    pdf = _select(m["mtype"], {MATTE: cosine_pdf(wo, wi),
                               METAL: metal_pdf(wo, wi, a),
                               SUBSTRATE: substrate_pdf(wo, wi, a)},
                  wo.shape[:1])
    wo_ok = wo[:, 2] != 0.0
    return (torch.where((reflect_ng & wo_ok)[:, None], f, 0.0),
            torch.where(wo_ok, pdf, 0.0))


def _stretch_half(u0, low):
    """u0 stretched back over [0, 1) within the half it fell in."""
    one_minus = sobol.ONE_MINUS_EPSILON
    return torch.where(low, torch.clamp_max(2.0 * u0, one_minus),
                       torch.clamp_max(2.0 * (u0 - 0.5), one_minus))


def sample_f(m, wo, u):
    """Each lane's BSDF sample for local wo and u (N, 2): dict(wi, f, pdf,
    specular, transmission)."""
    mtype, a = m["mtype"], m["alpha"]
    u0 = u[:, 0]
    wis, fs, pdfs = {}, {}, {}

    wi = flip_to(cosine_direction(u), wo)
    wis[MATTE], fs[MATTE], pdfs[MATTE] = wi, m["kd"] * INV_PI, \
        cosine_pdf(wo, wi)

    wh = tr_sample_wh(wo, u, a)
    wi = reflect(wo, wh)
    ok = (wo[:, 2] != 0.0) & (dot(wo, wh) >= 0.0) & same_hemisphere(wo, wi)
    wis[METAL] = wi
    pdfs[METAL] = torch.where(ok, tr_pdf(wo, wh, a) / torch.clamp_min(
        4.0 * dot(wo, wh), 1e-20), 0.0)
    fs[METAL] = torch.where(ok[:, None], metal_f(m, wo, wi), 0.0)

    low = u0 < 0.5
    us = torch.stack([_stretch_half(u0, low), u[:, 1]], -1)
    wi = torch.where(low[:, None], flip_to(cosine_direction(us), wo),
                     reflect(wo, tr_sample_wh(wo, us, a)))
    ok = low | same_hemisphere(wo, wi)
    wis[SUBSTRATE] = wi
    pdfs[SUBSTRATE] = torch.where(ok, substrate_pdf(wo, wi, a), 0.0)
    fs[SUBSTRATE] = torch.where(ok[:, None], substrate_f(m, wo, wi), 0.0)

    eta = m["eta"][:, 0]
    cos_o = wo[:, 2]
    fr = fr_dielectric(cos_o, eta)
    take_refl = u0 < fr
    wi_r = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    f_r = fr[:, None] * m["kd"] / \
        torch.clamp_min(torch.abs(wi_r[:, 2]), 1e-20)[:, None]
    entering = cos_o > 0.0
    ei = torch.where(entering, 1.0, eta)
    et = torch.where(entering, eta, 1.0)
    rel = ei / et
    nz = torch.where(entering, 1.0, -1.0)  # the normal on wo's side
    cos_i = nz * cos_o
    sin2_t = rel * rel * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    cos_t = sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    n_side = torch.stack([torch.zeros_like(nz), torch.zeros_like(nz), nz],
                         -1)
    wi_t = rel[:, None] * -wo + (rel * cos_i - cos_t)[:, None] * n_side
    f_t = m["ks"] * (1.0 - fr)[:, None] * ((ei * ei) / (et * et))[:, None] \
        / torch.clamp_min(torch.abs(wi_t[:, 2]), 1e-20)[:, None]
    f_t = torch.where((sin2_t < 1.0)[:, None], f_t, 0.0)
    wis[GLASS] = torch.where(take_refl[:, None], wi_r, wi_t)
    fs[GLASS] = torch.where(take_refl[:, None], f_r, f_t)
    pdfs[GLASS] = torch.where(take_refl, fr, 1.0 - fr)

    glass = mtype == GLASS
    return dict(wi=_select(mtype, wis, wo.shape),
                f=_select(mtype, fs, wo.shape),
                pdf=_select(mtype, pdfs, wo.shape[:1]),
                specular=glass, transmission=glass & ~take_refl)


# ------------------------------------------------------------ the vertex
def vertex(scene, tri, b):
    """pbrt-v3's surface interaction of a triangle hit, as
    ``diffuse_path.vertex``: the position and its error bound, the
    interpolated shading normal, the geometric normal turned to it, the
    shading frame from dp/du; each dot product, cross product and root
    taken as the functions above take them, so that a frame rounds alike
    wherever it is built."""
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    p0, p1, p2 = scene.p0[tri], scene.p1[tri], scene.p2[tri]
    p = b0 * p0 + b1 * p1 + b2 * p2
    err = dp.gamma(7) * (torch.abs(b0 * p0) + torch.abs(b1 * p1)
                         + torch.abs(b2 * p2))
    ns = b0 * scene.n0[tri] + b1 * scene.n1[tri] + b2 * scene.n2[tri]
    ns_len = dot(ns, ns)
    ng = scene.ng[tri]
    ns = torch.where((ns_len > 0.0)[:, None],
                     ns / sqrt(torch.clamp_min(ns_len, 1e-30))[:, None], ng)
    ng = torch.where((dot(ng, ns) < 0.0)[:, None], -ng, ng)
    ss0 = normalize(scene.dpdu[tri])
    ts = cross(ss0, ns)
    ts_len = dot(ts, ts)
    ts_n = ts / sqrt(torch.clamp_min(ts_len, 1e-30))[:, None]
    ss = torch.where((ts_len > 0.0)[:, None], cross(ts_n, ns),
                     dp.coordinate_u(ns))
    return dict(p=p, err=err, ng=ng, ns=ns, ss=ss, ts=cross(ns, ss))


def to_local(v, w):
    return torch.stack([dot(w, v["ss"]), dot(w, v["ts"]), dot(w, v["ns"])],
                       -1)


def offset_origin(p, p_err, n, w):
    """pbrt's robust ray origin (``diffuse_path.offset_origin``)."""
    off = dot(torch.abs(n), p_err)[:, None] * n
    off = torch.where((dot(w, n) < 0.0)[:, None], -off, off)
    po = p + off
    po = torch.where(off > 0.0, dp.next_up(po), po)
    return torch.where(off < 0.0, dp.next_down(po), po)


def cosine_direction(u):
    """``diffuse_path.cosine_direction`` with its z root correctly
    rounded."""
    w = dp.cosine_direction(u)
    x, y = w[:, 0], w[:, 1]
    return torch.stack([x, y, sqrt(torch.clamp_min(1.0 - x * x - y * y,
                                                   0.0))], -1)


def camera_rays(camera: dict, resolution, x, y):
    """``diffuse_path.camera_rays``, each product taken as a matrix
    product and each length as a vector norm, as the JAX package takes
    them: the image-plane point of (x, y) in homogeneous form times the
    transposed raster-to-camera matrix, divided by its w; its direction
    over its norm, turned by the camera's rotation, over its norm."""
    dev = x.device
    r2c = torch.as_tensor(dp.raster_to_camera(camera, resolution)
                          .astype(np.float32), device=dev)
    c2w = np.asarray(camera["cam_to_world"], np.float64)
    rot = torch.as_tensor(c2w[:3, :3].astype(np.float32), device=dev)
    ph = torch.stack([x, y, torch.zeros_like(x), torch.ones_like(x)], -1)
    pc = ph @ r2c.T
    p = pc[:, :3] / pc[:, 3:4]
    d = (p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)) @ rot.T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = torch.as_tensor(c2w[:3, 3].astype(np.float32), device=dev)
    return o.expand_as(d), d


# --------------------------------------------------------------- the scene
class Scene(dp.Scene):
    """``diffuse_path.Scene`` with each triangle's material row."""

    def __init__(self, tris: dict, device):
        super().__init__(tris, device)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self.mtype = t(tris["mtype"])
        self.ks, self.eta, self.k = t(tris["ks"]), t(tris["eta"]), \
            t(tris["k"])
        self.alpha = t(tris["alpha"])

    def material(self, tri) -> dict:
        return dict(mtype=self.mtype[tri], kd=self.kd[tri], ks=self.ks[tri],
                    eta=self.eta[tri], k=self.k[tri], alpha=self.alpha[tri])


# ------------------------------------------------------------------ paths
def trace(scene: Scene, draws: sobol.Draws, o, d, max_depth: int, q):
    """Radiance of each lane's path from the camera ray (o, d)."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    big_l = torch.zeros((n, 3), dtype=f32, device=dev)
    lane = torch.arange(n, device=dev)  # the wave's lanes still running
    beta = torch.ones((n, 3), dtype=f32, device=dev)
    eta_scale = torch.ones((n,), dtype=f32, device=dev)
    # the camera vertex's emission counts at full weight, as a specular
    # bounce's does
    specular = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), dtype=f32, device=dev)
    prev_p, prev_err, prev_ng = o, torch.zeros_like(o), torch.zeros_like(o)
    pick = 1.0 / max(scene.n_lights, 1)
    for bounce in range(max_depth + 1):
        if lane.numel() == 0:
            break
        base = 2 + DIMS_PER_BOUNCE * bounce
        dr = sobol.Draws(draws.index[lane], draws.scramble[lane])
        k = lane.numel()
        hit, tri, b = scene.closest(o, d)

        # emission
        facing = dot(scene.ng_emit[tri], -d) > 0.0
        le = torch.where(facing[:, None], scene.emit[tri], 0.0)
        if bounce == 0:
            w_em = torch.ones((k,), dtype=f32, device=dev)
        else:
            light = torch.clamp_min(scene.light[tri], 0)
            lpdf = scene.light_pdf(light, prev_p, prev_err, prev_ng, d) * pick
            w_em = torch.where(specular, 1.0,
                               dp.power_heuristic(prev_pdf, lpdf))
        big_l[lane] = q(big_l[lane] + torch.where(
            hit[:, None], beta * le * w_em[:, None], 0.0))
        if bounce == max_depth:
            break

        v = vertex(scene, tri, b)
        v["p"], v["err"] = q(v["p"]), q(v["err"])
        m = scene.material(tri)
        wo = -d
        wo_l = to_local(v, wo)

        # light sampling at the non-specular vertices
        u_light = dr.two(base + 0)
        if scene.n_lights > 1:
            light = torch.clamp_max(
                (dr.one(base + 4) * float(scene.n_lights)).to(torch.int64),
                scene.n_lights - 1)
        else:
            light = torch.zeros((k,), dtype=torch.int64, device=dev)
        lp, ln, lerr, lemit = scene.sample_light(light, u_light)
        wi = normalize(lp - v["p"])
        lpdf = scene.light_pdf(light, v["p"], v["err"], v["ng"], wi)
        li = torch.where((dot(ln, -wi) > 0.0)[:, None], lemit, 0.0)
        reflect_ng = dot(wi, v["ng"]) * dot(wo, v["ng"]) > 0.0
        f, scatter_pdf = eval_f_pdf(m, wo_l, to_local(v, wi), reflect_ng)
        f = f * torch.abs(dot(wi, v["ns"]))[:, None]
        pdf_eff = lpdf * pick
        useful = (m["mtype"] != GLASS) & hit & (lpdf > 0.0) & \
            (li != 0.0).any(-1) & (f != 0.0).any(-1)
        contrib = f * li * dp.power_heuristic(pdf_eff, scatter_pdf)[:, None] \
            / torch.clamp_min(pdf_eff, 1e-20)[:, None]
        ask = torch.nonzero(useful)[:, 0]
        so = offset_origin(v["p"][ask], v["err"][ask], v["ng"][ask],
                           lp[ask] - v["p"][ask])
        target = offset_origin(lp[ask], lerr[ask], ln[ask], so - lp[ask])
        lit = torch.zeros_like(useful)
        lit[ask] = ~scene.occluded(so, target - so, torch.full(
            (ask.numel(),), 1.0 - dp.SHADOW_EPSILON, dtype=f32, device=dev))
        big_l[lane] = q(big_l[lane] + torch.where(lit[:, None],
                                                  beta * contrib, 0.0))

        # the next direction, by the BSDF
        bs = sample_f(m, wo_l, dr.two(base + 5))
        wi = dp.to_world(v, bs["wi"])
        dead = (bs["f"] == 0.0).all(-1) | (bs["pdf"] == 0.0)
        go = hit & ~dead
        new_beta = beta * bs["f"] * (
            torch.abs(dot(wi, v["ns"]))
            / torch.clamp_min(bs["pdf"], 1e-20))[:, None]
        beta = q(torch.where(go[:, None], new_beta, beta))
        specular = torch.where(go, bs["specular"], specular)
        prev_pdf = torch.where(go, bs["pdf"], prev_pdf)
        prev_p = torch.where(go[:, None], v["p"], prev_p)
        prev_err = torch.where(go[:, None], v["err"], prev_err)
        prev_ng = torch.where(go[:, None], v["ng"], prev_ng)
        eta = m["eta"][:, 0]
        eta_scale = torch.where(
            go & bs["transmission"],
            eta_scale * torch.where(dot(wo, v["ng"]) > 0.0, eta * eta,
                                    1.0 / torch.clamp_min(eta * eta, 1e-20)),
            eta_scale)
        o = q(torch.where(go[:, None],
                          offset_origin(v["p"], v["err"], v["ng"], wi), o))
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
        lane, o, d, beta, eta_scale, specular, prev_pdf, prev_p, prev_err, \
            prev_ng = (x[keep] for x in (lane, o, d, beta, eta_scale,
                                         specular, prev_pdf, prev_p,
                                         prev_err, prev_ng))
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
    scene = Scene(sphere_scene.load(config["scene"]["path"]), dev)
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
        o, d = camera_rays(camera, (w, h), pxf + jx, pyf + jy)
        radiance = trace(scene, draws, q(o), q(d), traffic["max_depth"], q)
        dp.splat(film, q(radiance), pxi, pyi, jx, jy, row, q)
    return q(film)
