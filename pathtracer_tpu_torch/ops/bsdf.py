"""BSDF sample / eval / pdf for every material model.

Port of ``pathtracer_tpu/ops/bsdf.py``. Every material model present in
the scene is evaluated for the whole batch and the per-ray result is
selected by material type (the first matching branch wins, as
``jnp.select`` picks). All directions are in the local shading frame
(z = shading normal); the integrator converts world <-> local with the
per-hit (ss, ts, ns) frame.

  MATTE      Lambertian reflection (kd)
  MIRROR     specular reflection, Fresnel 1
  GLASS      Fresnel-weighted specular reflection / transmission
  METAL      Trowbridge-Reitz reflection, conductor Fresnel (eta, k)
  SUBSTRATE  Ashikhmin-Shirley FresnelBlend (kd, ks)
  DISNEY     Burley diffuse + GGX reflection with the Disney Fresnel
  ROUGHGLASS GGX reflection (kd) + GGX transmission (ks)

Textures: constant, checker and image descriptors; an image descriptor
reads the mip pool (``scene/texture.py``) at the filter width of the
camera rays' differentials.

While a profiler records, the branches of METAL, SUBSTRATE and GLASS
each run in a span of their own (``pt::bsdf:metal``,
``pt::bsdf:substrate``, ``pt::bsdf:glass``; ``utils/spans.py``), in
``eval_f_pdf`` and ``sample_f`` alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as pm
from ..core.math import ONE_MINUS_EPSILON
from ..core.sampling import cosine_sample_hemisphere
from ..scene.scene import (MA_ETA, MA_K, MA_KD, MA_KS, MA_MISC, MA_REMAP,
                           MA_ROUGH, MA_TYPE, MAT_DISNEY, MAT_GLASS,
                           MAT_MATTE, MAT_METAL, MAT_MIRROR, MAT_ROUGHGLASS,
                           MAT_SUBSTRATE, pack_mat_attr)
from ..scene.texture import lookup_width
from ..utils.spans import span
from .cuda import texture_cu

INV_PI = float(np.float32(1.0 / np.pi))
ALL_MATERIALS = (MAT_MATTE, MAT_MIRROR, MAT_GLASS, MAT_METAL, MAT_SUBSTRATE,
                 MAT_DISNEY, MAT_ROUGHGLASS)


def select(preds, vals, default):
    """The first value whose predicate holds, else ``default`` (the
    semantics of ``jnp.select``); each predicate broadcasts against its
    value."""
    out = default
    for p, v in zip(reversed(preds), reversed(vals)):
        out = torch.where(p, v, out)
    return out


def _sel3(preds, vals, default):
    return select([p[..., None] for p in preds], vals, default)


# ---------------------------------------------------------------- local frame
def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def reflect_local(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def reflect_about(wo, n):
    return -wo + 2.0 * pm.dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Snell refraction of wi about n with relative IOR eta. Returns
    (wt, ok); ok is False under total internal reflection."""
    cos_i = pm.dot(n, wi)
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = pm.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wt = eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n
    return wt, ok


def _flip_to_wo_side(wi, wo):
    flip = pm.device_const((1.0, 1.0, -1.0), wi.device, wi.dtype)
    return torch.where((wo[..., 2] < 0.0)[..., None], wi * flip, wi)


# ------------------------------------------------------------------- fresnel
def fr_dielectric(cos_i, eta_i, eta_t):
    """Dielectric Fresnel reflectance, from either side."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_i = pm.sqrt(torch.clamp_min(1.0 - ci * ci, 0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = pm.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp_min(et * ci + ei * ct, 1e-20)
    r_perp = (ei * ci - et * ct) / torch.clamp_min(ei * ci + et * ct, 1e-20)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fr_conductor(cos_i, eta_i, eta_t, k):
    """Conductor Fresnel with a complex IOR (eta_t, k), rgb."""
    ci = torch.clamp(cos_i, -1.0, 1.0)[..., None]
    eta = eta_t / eta_i
    etak = k / eta_i
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - si2
    a2b2 = pm.sqrt(torch.clamp_min(t0 * t0 + 4.0 * eta2 * etak2, 0.0))
    t1 = a2b2 + ci2
    a = pm.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * ci * a
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-20)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-20)
    return 0.5 * (rp + rs)


def schlick_weight(cos_t):
    m = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return (m * m) * (m * m) * m


def fr_schlick_spectrum(r0, cos_t):
    return pm.lerp(r0, torch.ones_like(r0), schlick_weight(cos_t)[..., None])


def disney_fresnel(c_spec0, metallic, eta, cos_i):
    """Dielectric Fresnel lerped to Schlick's by metallic."""
    diel = fr_dielectric(cos_i, torch.ones_like(cos_i), eta)[..., None]
    schlick = fr_schlick_spectrum(c_spec0, cos_i)
    return pm.lerp(diel.expand(schlick.shape), schlick, metallic[..., None])


# ------------------------------------------------- Trowbridge-Reitz (GGX)
def roughness_to_alpha(roughness):
    """Log-poly roughness remap."""
    x = torch.log(torch.clamp_min(roughness, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x * x * x + 0.000640711 * x * x * x * x)


def _cos_sin_phi(w, sin_t):
    inv_sin = 1.0 / torch.clamp_min(sin_t, 1e-20)
    on_pole = sin_t == 0.0
    cphi = torch.where(on_pole, 1.0,
                       torch.clamp(w[..., 0] * inv_sin, -1.0, 1.0))
    sphi = torch.where(on_pole, 1.0,
                       torch.clamp(w[..., 1] * inv_sin, -1.0, 1.0))
    return cphi, sphi


def tr_d(wh, ax, ay):
    """GGX normal distribution D(wh)."""
    c2 = wh[..., 2] * wh[..., 2]
    s2 = torch.clamp_min(1.0 - c2, 0.0)
    tan2 = s2 / torch.clamp_min(c2, 1e-20)
    finite = c2 > 0.0
    cos4 = c2 * c2
    cphi, sphi = _cos_sin_phi(wh, pm.sqrt(s2))
    e = (cphi * cphi / (ax * ax) + sphi * sphi / (ay * ay)) * tan2
    d = 1.0 / (np.pi * ax * ay * cos4 * (1.0 + e) * (1.0 + e))
    return torch.where(finite, d, 0.0)


def tr_lambda(w, ax, ay):
    """Smith masking Lambda(w)."""
    c2 = w[..., 2] * w[..., 2]
    s2 = torch.clamp_min(1.0 - c2, 0.0)
    abs_tan = pm.sqrt(s2) / torch.clamp_min(torch.abs(w[..., 2]), 1e-20)
    finite = c2 > 0.0
    cphi, sphi = _cos_sin_phi(w, pm.sqrt(s2))
    alpha = pm.sqrt(cphi * cphi * ax * ax + sphi * sphi * ay * ay)
    a2t2 = (alpha * abs_tan) * (alpha * abs_tan)
    lam = (-1.0 + pm.sqrt(1.0 + a2t2)) / 2.0
    return torch.where(finite, lam, 0.0)


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay, separable=None):
    """Smith G; where ``separable`` holds, G1(wo) G1(wi) (Disney)."""
    joint = 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))
    if separable is None:
        return joint
    sep = tr_g1(wo, ax, ay) * tr_g1(wi, ax, ay)
    return torch.where(separable, sep, joint)


def _tr_sample_11(cos_t, u1, u2):
    """Visible-normal slope sampling for an isotropic unit roughness."""
    # normal-incidence branch
    r_ni = pm.sqrt(torch.clamp_min(
        u1 / torch.clamp_min(1.0 - u1, 1e-20), 0.0))
    phi_ni = 2.0 * np.pi * u2
    sx_ni = r_ni * torch.cos(phi_ni)
    sy_ni = r_ni * torch.sin(phi_ni)

    # general branch (every division guarded; selected only where
    # cos_t <= 0.9999)
    ct = torch.clamp(cos_t, 1e-6, 0.9999)
    sin_t = pm.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    tan_t = sin_t / ct
    a = 1.0 / tan_t
    g1 = 2.0 / (1.0 + pm.sqrt(1.0 + 1.0 / (a * a)))
    A = 2.0 * u1 / g1 - 1.0
    denom = A * A - 1.0
    tmp = torch.where(denom == 0.0, 1e10,
                      1.0 / torch.where(denom == 0.0, 1.0, denom))
    tmp = torch.clamp_max(tmp, 1e10)
    B = tan_t
    D = pm.sqrt(torch.clamp_min(B * B * tmp * tmp - (A * A - B * B) * tmp,
                                   0.0))
    sx1 = B * tmp - D
    sx2 = B * tmp + D
    sx = torch.where((A < 0.0) | (sx2 > 1.0 / tan_t), sx1, sx2)
    flip = u2 > 0.5
    s = torch.where(flip, 1.0, -1.0)
    u2b = torch.where(flip, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = (u2b * (u2b * (u2b * 0.27385 - 0.73369) + 0.46341)) / \
        (u2b * (u2b * (u2b * 0.093073 + 0.309420) - 1.000000) + 0.597999)
    sy = s * z * pm.sqrt(1.0 + sx * sx)

    ni = cos_t > 0.9999
    return torch.where(ni, sx_ni, sx), torch.where(ni, sy_ni, sy)


def tr_sample_wh(wo, u, ax, ay):
    """Sample a visible GGX microfacet normal wh for wo."""
    flip = wo[..., 2] < 0.0
    w = torch.where(flip[..., None], -wo, wo)
    wi_str = pm.normalize(torch.stack(
        [ax * w[..., 0], ay * w[..., 1], w[..., 2]], dim=-1))
    sx, sy = _tr_sample_11(cos_theta(wi_str), u[..., 0], u[..., 1])
    s2 = torch.clamp_min(1.0 - wi_str[..., 2] * wi_str[..., 2], 0.0)
    cphi, sphi = _cos_sin_phi(wi_str, pm.sqrt(s2))
    sx, sy = cphi * sx - sphi * sy, sphi * sx + cphi * sy
    sx = ax * sx
    sy = ay * sy
    wh = pm.normalize(torch.stack([-sx, -sy, torch.ones_like(sx)], dim=-1))
    return torch.where(flip[..., None], -wh, wh)


def tr_pdf(wo, wh, ax, ay):
    """Visible-normal pdf of wh."""
    return tr_d(wh, ax, ay) * tr_g1(wo, ax, ay) * \
        torch.abs(pm.dot(wo, wh)) / torch.clamp_min(abs_cos_theta(wo), 1e-20)


# ---------------------------------------------------------------- textures
def eval_texture(scene, txd_id, uv, fallback, duv=None, image=True):
    """Evaluate texture descriptors ``txd_id`` (N,) at uv (N, 2)
    (``eval_texture_plain`` has the semantics): kernel K3 on the card
    (``ops/cuda/texture_cu.texture_eval``, one launch), the plain version
    on the CPU. Spanned ``pt::texture`` (``utils/spans.py``)."""
    with span("pt::texture"):
        return texture_cu.texture_eval(scene, txd_id, uv, fallback, duv=duv,
                                       image=image)


def eval_texture_plain(scene, txd_id, uv, fallback, duv=None, image=True):
    """The plain PyTorch version of K3 (``eval_texture``): texture
    descriptors ``txd_id`` (N,) evaluated at uv (N, 2) over their UV map
    (su, sv, ou, ov): constant, checker, and image through the mip pool;
    ``fallback`` (N, 3) where txd_id < 0.

    duv = (dudx, dvdx, dudy, dvdy), the screen-space UV derivatives
    (interaction.compute_duv): the filter width is the largest of them
    scaled by the UV map; without them the width is 0 (level 0). An image
    descriptor scales its texels by ``txd_scale`` after the sRGB decode
    and broadcasts ``txd_channel`` when it is >= 0. ``image=False``, for a
    scene that binds no image descriptor, skips the pool lookup, whose
    result no lane would select.
    """
    safe = torch.clamp_min(txd_id, 0).long()
    kind = scene.txd_kind[safe]
    uvm = scene.txd_uv[safe]
    st0 = uv[..., 0] * uvm[..., 0] + uvm[..., 2]
    st1 = uv[..., 1] * uvm[..., 1] + uvm[..., 3]
    const_v = scene.txd_rgb0[safe]
    parity = torch.remainder(torch.floor(st0) + torch.floor(st1), 2.0)
    checker_v = torch.where((parity == 0.0)[..., None],
                            scene.txd_rgb0[safe], scene.txd_rgb1[safe])
    val = torch.where((kind == 1)[..., None], checker_v, const_v)
    if image:
        if duv is None:
            width = 0.0
        else:
            dudx, dvdx, dudy, dvdy = duv
            su, sv = uvm[..., 0], uvm[..., 1]
            width = torch.maximum(
                torch.maximum(torch.abs(su * dudx), torch.abs(sv * dvdx)),
                torch.maximum(torch.abs(su * dudy), torch.abs(sv * dvdy)))
        img_v = lookup_width(scene.tex, scene.txd_image[safe],
                             torch.stack([st0, st1], dim=-1), width)
        img_v = torch.where(scene.txd_srgb[safe][..., None],
                            pm.inverse_gamma_correct(img_v), img_v)
        img_v = img_v * scene.txd_scale[safe]
        ch = scene.txd_channel[safe]
        ch_v = torch.take_along_dim(
            img_v, torch.clamp_min(ch, 0).long()[..., None], dim=-1)
        img_v = torch.where((ch >= 0)[..., None], ch_v.expand_as(img_v),
                            img_v)
        val = torch.where((kind == 2)[..., None], img_v, val)
    return torch.where((txd_id >= 0)[..., None], val, fallback)


# ---------------------------------------------------------------- materials
def gather_params(scene, mat_id, uv=None, mat_attr=None, has_tex=True,
                  duv=None, tex_channels=None, image_tex=True):
    """Per-ray material parameters from the packed (M, MA_WIDTH) material
    table (built from ``scene`` when omitted). With uv given and
    ``has_tex``, the texture-bound parameters (kd, ks, metallic,
    roughness; ``tex_channels`` says which any material binds) evaluate
    their descriptors at the UV derivatives ``duv`` (None: width 0);
    ``image_tex=False`` says no bound descriptor is an image
    (eval_texture's ``image``)."""
    if mat_attr is None:
        mat_attr = torch.as_tensor(pack_mat_attr(scene), device=mat_id.device)
    mid = mat_id.long()
    rows = mat_attr[mid]
    rough = rows[:, MA_ROUGH]
    ax_raw, ay_raw = rough[:, 0], rough[:, 1]
    remap = rows[:, MA_REMAP] > 0.5
    ax = torch.where(remap, roughness_to_alpha(ax_raw), ax_raw)
    ay = torch.where(remap, roughness_to_alpha(ay_raw), ay_raw)
    mtype = rows[:, MA_TYPE].to(torch.int32)
    kd = rows[:, MA_KD]
    ks = rows[:, MA_KS]
    misc = rows[:, MA_MISC]
    metallic = misc[:, 0]
    rough_d = misc[:, 1]
    if uv is not None and has_tex:
        ck, cs, cm, cr = tex_channels or (True,) * 4
        kw = dict(duv=duv, image=image_tex)
        if ck:
            kd = eval_texture(scene, scene.mat_kd_tx[mid], uv, kd, **kw)
        if cs:
            ks = eval_texture(scene, scene.mat_ks_tx[mid], uv, ks, **kw)
        if cm:
            metallic = eval_texture(scene, scene.mat_metallic_tx[mid], uv,
                                    metallic[..., None].expand(-1, 3),
                                    **kw)[..., 0]
        if cr:
            rough_d = eval_texture(scene, scene.mat_rough_tx[mid], uv,
                                   rough_d[..., None].expand(-1, 3),
                                   **kw)[..., 0]
    # Disney derives its own alphas: max(0.001, roughness^2)
    alpha_d = torch.clamp_min(rough_d * rough_d, 0.001)
    is_disney = mtype == MAT_DISNEY
    return dict(
        mtype=mtype, kd=kd, ks=ks,
        eta3=rows[:, MA_ETA], eta=rows[:, MA_ETA][:, 0], k=rows[:, MA_K],
        ax=torch.where(is_disney, alpha_d, torch.clamp_min(ax, 0.001)),
        ay=torch.where(is_disney, alpha_d, torch.clamp_min(ay, 0.001)),
        metallic=metallic,
    )


def _disney_lobes(mp):
    """Disney's diffuse color (1 - metallic) c and specular color c_spec0."""
    c = mp["kd"]
    metallic = mp["metallic"]
    diffuse_weight = 1.0 - metallic
    eta = mp["eta"]
    r0 = ((eta - 1.0) * (eta - 1.0) / ((eta + 1.0) * (eta + 1.0)))[..., None]
    c_spec0 = pm.lerp(r0 * torch.ones_like(c), c, metallic[..., None])
    return diffuse_weight[..., None] * c, c_spec0


def _microfacet_f(r, wo, wi, ax, ay, fresnel_fn, separable=None):
    """Torrance-Sparrow reflection f."""
    cto = abs_cos_theta(wo)
    cti = abs_cos_theta(wi)
    wh = wi + wo
    wh_ok = pm.norm_sq(wh) > 0.0
    whn = pm.normalize(wh)
    fr = fresnel_fn(pm.dot(wi, whn))
    val = r * tr_d(whn, ax, ay)[..., None] * \
        tr_g(wo, wi, ax, ay, separable)[..., None] * fr / \
        torch.clamp_min(4.0 * cti * cto, 1e-20)[..., None]
    ok = wh_ok & (cti > 0.0) & (cto > 0.0)
    return torch.where(ok[..., None], val, 0.0)


def _microfacet_pdf(wo, wi, ax, ay):
    """Reflection pdf; zero unless wo and wi share a hemisphere."""
    wh = pm.normalize(wo + wi)
    pdf = tr_pdf(wo, wh, ax, ay) / torch.clamp_min(4.0 * pm.dot(wo, wh),
                                                   1e-20)
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def _mf_trans_f(t, wo, wi, ax, ay, eta_b):
    """Microfacet transmission f in radiance mode; eta_b is the interior
    IOR (eta_a = 1). Transmission needs opposite hemispheres, with eta =
    eta_b / eta_a when wo is outside (the reference's consistent form)."""
    cto = abs_cos_theta(wo)
    cti = abs_cos_theta(wi)
    eta = torch.where(cos_theta(wo) > 0.0, eta_b, 1.0 / eta_b)
    wh = wo + wi * eta[..., None]
    wh_ok = pm.norm_sq(wh) > 0.0
    whn = pm.normalize(wh)
    whn = torch.where((whn[..., 2] < 0.0)[..., None], -whn, whn)
    d_o, d_i = pm.dot(wo, whn), pm.dot(wi, whn)
    fr = fr_dielectric(d_o, torch.ones_like(eta_b), eta_b)
    sqrt_denom = d_o + eta * d_i
    factor = 1.0 / eta  # radiance transport
    val = (1.0 - fr)[..., None] * t * torch.abs(
        tr_d(whn, ax, ay) * tr_g(wo, wi, ax, ay) * eta * eta *
        torch.abs(d_i) * torch.abs(d_o) * factor * factor /
        torch.clamp_min(cti * cto * sqrt_denom * sqrt_denom, 1e-20))[..., None]
    ok = ~same_hemisphere(wo, wi) & (cti > 0.0) & (cto > 0.0) & \
        ~(d_o * d_i > 0.0) & wh_ok
    return torch.where(ok[..., None], val, 0.0)


def _mf_trans_pdf(wo, wi, ax, ay, eta_b):
    """Microfacet transmission pdf: tr_pdf(wo, wh) |dwh / dwi|."""
    eta = torch.where(cos_theta(wo) > 0.0, eta_b, 1.0 / eta_b)
    wh_raw = wo + wi * eta[..., None]
    # a degenerate half vector normalizes to NaN, which the ~(d_o d_i > 0)
    # test would pass: guard it as _mf_trans_f does
    wh_ok = pm.norm_sq(wh_raw) > 0.0
    wh = pm.normalize(wh_raw)
    d_o, d_i = pm.dot(wo, wh), pm.dot(wi, wh)
    sqrt_denom = d_o + eta * d_i
    dwh_dwi = torch.abs(eta * eta * d_i /
                        torch.clamp_min(sqrt_denom * sqrt_denom, 1e-20))
    pdf = tr_pdf(wo, wh, ax, ay) * dwh_dwi
    ok = wh_ok & ~same_hemisphere(wo, wi) & ~(d_o * d_i > 0.0)
    return torch.where(ok, pdf, 0.0)


def _pow5(v):
    return (v * v) * (v * v) * v


def _fresnel_blend_f(rd, rs, wo, wi, ax, ay):
    """Ashikhmin-Shirley substrate f."""
    diffuse = (28.0 / (23.0 * np.pi)) * rd * (1.0 - rs) * \
        (1.0 - _pow5(1.0 - 0.5 * abs_cos_theta(wi)))[..., None] * \
        (1.0 - _pow5(1.0 - 0.5 * abs_cos_theta(wo)))[..., None]
    wh = wi + wo
    wh_ok = pm.norm_sq(wh) > 0.0
    whn = pm.normalize(wh)
    schlick = rs + _pow5(1.0 - pm.dot(wi, whn))[..., None] * (1.0 - rs)
    spec = (tr_d(whn, ax, ay) /
            torch.clamp_min(4.0 * torch.abs(pm.dot(wi, whn)) *
                            torch.maximum(abs_cos_theta(wi),
                                          abs_cos_theta(wo)),
                            1e-20))[..., None] * schlick
    return torch.where(wh_ok[..., None], diffuse + spec, 0.0)


def _fresnel_blend_pdf(wo, wi, ax, ay):
    wh = pm.normalize(wo + wi)
    pdf_wh = tr_pdf(wo, wh, ax, ay)
    pdf = 0.5 * (abs_cos_theta(wi) * INV_PI +
                 pdf_wh / torch.clamp_min(4.0 * pm.dot(wo, wh), 1e-20))
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def _disney_diffuse_f(r, wo, wi):
    """Burley diffuse."""
    fo = schlick_weight(abs_cos_theta(wo))
    fi = schlick_weight(abs_cos_theta(wi))
    return r * INV_PI * ((1.0 - fo / 2.0) * (1.0 - fi / 2.0))[..., None]


def _cosine_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI,
                       0.0)


def _conductor_fn(mp):
    return lambda ci: fr_conductor(torch.abs(ci),
                                   torch.ones_like(mp["eta3"]), mp["eta3"],
                                   mp["k"])


def _dielectric_fn(eta_b):
    return lambda ci: fr_dielectric(ci, torch.ones_like(eta_b),
                                    eta_b)[..., None]


def _disney_f(mp, dif_c, c_spec0, wo, wi, ax, ay):
    sep = torch.ones_like(mp["eta"], dtype=torch.bool)
    return _disney_diffuse_f(dif_c, wo, wi) + _microfacet_f(
        torch.ones_like(dif_c), wo, wi, ax, ay,
        lambda ci: disney_fresnel(c_spec0, mp["metallic"], mp["eta"], ci),
        separable=sep)


def eval_f_pdf(mp, wo, wi, reflect_ng, present=ALL_MATERIALS):
    """BSDF f and pdf for NEE's light branch (flags = ALL - SPECULAR).

    wo, wi local; reflect_ng: (N,) bool, (wi.ng)(wo.ng) > 0 in world
    space. Specular materials (mirror, glass) give f = 0, pdf = 0.
    ``present`` is the set of material types in the scene: the others are
    not evaluated.
    """
    mtype = mp["mtype"]
    ax, ay = mp["ax"], mp["ay"]
    wo_ok = wo[..., 2] != 0.0
    preds, fs, pdfs = [], [], []

    if MAT_MATTE in present:
        preds.append(mtype == MAT_MATTE)
        fs.append(mp["kd"] * INV_PI)
        pdfs.append(_cosine_pdf(wo, wi))

    if MAT_METAL in present:
        with span("pt::bsdf:metal"):
            preds.append(mtype == MAT_METAL)
            fs.append(_microfacet_f(mp["ks"], wo, wi, ax, ay,
                                    _conductor_fn(mp)))
            pdfs.append(_microfacet_pdf(wo, wi, ax, ay))

    if MAT_SUBSTRATE in present:
        with span("pt::bsdf:substrate"):
            preds.append(mtype == MAT_SUBSTRATE)
            fs.append(_fresnel_blend_f(mp["kd"], mp["ks"], wo, wi, ax, ay))
            pdfs.append(_fresnel_blend_pdf(wo, wi, ax, ay))

    if MAT_DISNEY in present:
        dif_c, c_spec0 = _disney_lobes(mp)
        preds.append(mtype == MAT_DISNEY)
        fs.append(_disney_f(mp, dif_c, c_spec0, wo, wi, ax, ay))
        pdfs.append(0.5 * (_cosine_pdf(wo, wi)
                           + _microfacet_pdf(wo, wi, ax, ay)))

    if MAT_ROUGHGLASS in present:
        # the ng hemisphere test routes f to the matching lobe; the pdf
        # averages both lobes
        eta_b = mp["eta"]
        f_refl = _microfacet_f(mp["kd"], wo, wi, ax, ay,
                               _dielectric_fn(eta_b))
        f_trans = _mf_trans_f(mp["ks"], wo, wi, ax, ay, eta_b)
        preds.append(mtype == MAT_ROUGHGLASS)
        fs.append(torch.where(reflect_ng[..., None], f_refl, f_trans))
        pdfs.append(0.5 * (_microfacet_pdf(wo, wi, ax, ay)
                           + _mf_trans_pdf(wo, wi, ax, ay, eta_b)))

    zero3 = torch.zeros(wo.shape[:-1] + (3,), dtype=torch.float32,
                        device=wo.device)
    zero1 = torch.zeros(wo.shape[:-1], dtype=torch.float32, device=wo.device)
    if not preds:
        return zero3, zero1
    f = _sel3(preds, fs, zero3)
    pdf = select(preds, pdfs, zero1)
    # every lobe but rough glass's transmission reflects: f is zero unless
    # the ng test agrees (rough glass routed f by reflect_ng above)
    allow = reflect_ng
    if MAT_ROUGHGLASS in present:
        allow = allow | (mtype == MAT_ROUGHGLASS)
    f = torch.where((allow & wo_ok)[..., None], f, 0.0)
    pdf = torch.where(wo_ok, pdf, 0.0)
    return f, pdf


def has_nonspecular(mtype):
    """Materials with at least one non-specular lobe (NEE applies)."""
    return (mtype != MAT_MIRROR) & (mtype != MAT_GLASS)


def _remap_half(u0, first):
    """u0 stretched back to [0, 1) within the half it fell in."""
    return torch.where(first, torch.clamp_max(2.0 * u0, ONE_MINUS_EPSILON),
                       torch.clamp_max(2.0 * (u0 - 0.5), ONE_MINUS_EPSILON))


def sample_f(mp, wo, u, reflect_ng_fn, present=ALL_MATERIALS):
    """Sample the BSDF (flags = ALL) for the path's next bounce.

    mp: material params; wo: local outgoing; u: (N, 2) in [0, 1);
    reflect_ng_fn: wi_local -> (N,) bool, the world-space geometric-normal
    reflection test (the multi-lobe models re-evaluate f with it).
    Returns dict(wi, f, pdf, specular, transmission).
    """
    mtype = mp["mtype"]
    ax, ay = mp["ax"], mp["ay"]
    u0, u1 = u[..., 0], u[..., 1]
    preds, wis, fs, pdfs = [], [], [], []
    glass_trans = torch.zeros(u0.shape, dtype=torch.bool, device=u.device)
    rough_trans = glass_trans

    if MAT_MATTE in present:
        wi_matte = _flip_to_wo_side(cosine_sample_hemisphere(u), wo)
        preds.append(mtype == MAT_MATTE)
        wis.append(wi_matte)
        fs.append(mp["kd"] * INV_PI)
        pdfs.append(_cosine_pdf(wo, wi_matte))

    if MAT_MIRROR in present:
        wi_mirror = reflect_local(wo)
        preds.append(mtype == MAT_MIRROR)
        wis.append(wi_mirror)
        fs.append(torch.ones_like(mp["kd"]) /
                  torch.clamp_min(abs_cos_theta(wi_mirror), 1e-20)[..., None])
        pdfs.append(torch.ones_like(u0))

    if MAT_GLASS in present:
        with span("pt::bsdf:glass"):
            eta_a = torch.ones_like(mp["eta"])
            eta_b = mp["eta"]
            fr = fr_dielectric(cos_theta(wo), eta_a, eta_b)
            take_refl = u0 < fr
            wi_gr = reflect_local(wo)
            f_gr = fr[..., None] * mp["kd"] / \
                torch.clamp_min(abs_cos_theta(wi_gr), 1e-20)[..., None]
            entering = cos_theta(wo) > 0.0
            ei = torch.where(entering, eta_a, eta_b)
            et = torch.where(entering, eta_b, eta_a)
            zero = torch.zeros_like(u0)
            n_ff = torch.stack(
                [zero, zero, torch.where(entering, 1.0, -1.0)], dim=-1)
            wi_gt, refr_ok = refract(wo, n_ff, ei / et)
            ft = mp["ks"] * (1.0 - fr)[..., None] * \
                ((ei * ei) / (et * et))[..., None] / \
                torch.clamp_min(abs_cos_theta(wi_gt), 1e-20)[..., None]
            f_gt = torch.where(refr_ok[..., None], ft, 0.0)
            preds.append(mtype == MAT_GLASS)
            wis.append(torch.where(take_refl[..., None], wi_gr, wi_gt))
            fs.append(torch.where(take_refl[..., None], f_gr, f_gt))
            pdfs.append(torch.where(take_refl, fr, 1.0 - fr))
            glass_trans = (mtype == MAT_GLASS) & ~take_refl

    if MAT_METAL in present:
        with span("pt::bsdf:metal"):
            wh_m = tr_sample_wh(wo, u, ax, ay)
            wi_metal = reflect_about(wo, wh_m)
            metal_ok = (wo[..., 2] != 0.0) & (pm.dot(wo, wh_m) >= 0.0) & \
                same_hemisphere(wo, wi_metal)
            preds.append(mtype == MAT_METAL)
            wis.append(wi_metal)
            pdfs.append(torch.where(
                metal_ok,
                tr_pdf(wo, wh_m, ax, ay) /
                torch.clamp_min(4.0 * pm.dot(wo, wh_m), 1e-20), 0.0))
            fs.append(torch.where(metal_ok[..., None], _microfacet_f(
                mp["ks"], wo, wi_metal, ax, ay, _conductor_fn(mp)), 0.0))

    if MAT_SUBSTRATE in present:
        with span("pt::bsdf:substrate"):
            half = u0 < 0.5
            us = torch.stack([_remap_half(u0, half), u1], dim=-1)
            wi_s_cos = _flip_to_wo_side(cosine_sample_hemisphere(us), wo)
            wi_s_spec = reflect_about(wo, tr_sample_wh(wo, us, ax, ay))
            wi_sub = torch.where(half[..., None], wi_s_cos, wi_s_spec)
            sub_ok = half | same_hemisphere(wo, wi_sub)
            preds.append(mtype == MAT_SUBSTRATE)
            wis.append(wi_sub)
            pdfs.append(torch.where(
                sub_ok, _fresnel_blend_pdf(wo, wi_sub, ax, ay), 0.0))
            fs.append(torch.where(
                sub_ok[..., None],
                _fresnel_blend_f(mp["kd"], mp["ks"], wo, wi_sub, ax, ay),
                0.0))

    if MAT_DISNEY in present:
        # uniform pick of the two lobes, u0 remapped into the lobe
        comp = torch.clamp_max(torch.floor(u0 * 2.0), 1.0)
        ud = torch.stack([u0 * 2.0 - comp, u1], dim=-1)
        take_diff = comp == 0.0
        wi_d_cos = _flip_to_wo_side(cosine_sample_hemisphere(ud), wo)
        wh_d = tr_sample_wh(wo, ud, ax, ay)
        wi_d_spec = reflect_about(wo, wh_d)
        spec_ok = (wo[..., 2] != 0.0) & (pm.dot(wo, wh_d) >= 0.0)
        wi_dis = torch.where(take_diff[..., None], wi_d_cos, wi_d_spec)
        dif_c, c_spec0 = _disney_lobes(mp)
        # pdf summed over both lobes, halved; f over both lobes
        pdf_dis = 0.5 * (_cosine_pdf(wo, wi_dis) +
                         _microfacet_pdf(wo, wi_dis, ax, ay))
        pdf_dis = torch.where(take_diff | spec_ok, pdf_dis, 0.0)
        f_dis = _disney_f(mp, dif_c, c_spec0, wo, wi_dis, ax, ay)
        f_dis = torch.where(
            (reflect_ng_fn(wi_dis) & (take_diff | spec_ok))[..., None],
            f_dis, 0.0)
        preds.append(mtype == MAT_DISNEY)
        wis.append(wi_dis)
        fs.append(f_dis)
        pdfs.append(pdf_dis)

    if MAT_ROUGHGLASS in present:
        # uniform pick of reflection / transmission, u0 remapped, then f
        # and pdf over both lobes
        eta_b = mp["eta"]
        take_refl = u0 < 0.5
        ug = torch.stack([_remap_half(u0, take_refl), u1], dim=-1)
        wh_g = tr_sample_wh(wo, ug, ax, ay)
        wh_valid = pm.dot(wo, wh_g) >= 0.0
        wi_gr = reflect_about(wo, wh_g)
        # refract about wh faced to wo's side
        entering = cos_theta(wo) > 0.0
        eta_ratio = torch.where(entering, 1.0 / eta_b, eta_b)
        wh_ff = torch.where((pm.dot(wo, wh_g) < 0.0)[..., None], -wh_g, wh_g)
        wi_gt, refr_ok = refract(wo, wh_ff, eta_ratio)
        wi_rg = torch.where(take_refl[..., None], wi_gr, wi_gt)
        lobe_ok = wh_valid & (wo[..., 2] != 0.0) & \
            torch.where(take_refl, same_hemisphere(wo, wi_gr), refr_ok)
        f_refl = _microfacet_f(mp["kd"], wo, wi_rg, ax, ay,
                               _dielectric_fn(eta_b))
        f_trans = _mf_trans_f(mp["ks"], wo, wi_rg, ax, ay, eta_b)
        reflect_ng_rg = reflect_ng_fn(wi_rg)
        f_rg = torch.where(reflect_ng_rg[..., None], f_refl, f_trans)
        pdf_rg = 0.5 * (_microfacet_pdf(wo, wi_rg, ax, ay)
                        + _mf_trans_pdf(wo, wi_rg, ax, ay, eta_b))
        preds.append(mtype == MAT_ROUGHGLASS)
        wis.append(wi_rg)
        fs.append(torch.where(lobe_ok[..., None], f_rg, 0.0))
        pdfs.append(torch.where(lobe_ok, pdf_rg, 0.0))
        rough_trans = (mtype == MAT_ROUGHGLASS) & ~reflect_ng_rg

    zero3 = torch.zeros(wo.shape[:-1] + (3,), dtype=torch.float32,
                        device=wo.device)
    zero1 = torch.zeros(wo.shape[:-1], dtype=torch.float32, device=wo.device)
    if preds:
        wi = _sel3(preds, wis, wis[0])
        f = _sel3(preds, fs, zero3)
        pdf = select(preds, pdfs, zero1)
    else:
        wi = pm.device_const((0.0, 0.0, 1.0), wo.device).expand(wo.shape)
        f, pdf = zero3, zero1
    specular = (mtype == MAT_MIRROR) | (mtype == MAT_GLASS)
    return dict(wi=wi, f=f, pdf=pdf, specular=specular,
                transmission=glass_trans | rough_trans)
