"""Wavefront path integrator: NEE + MIS + Russian roulette, fully batched.

Port of ``pathtracer_tpu/integrator.py`` in its fused form, for opaque
scenes of every material model (constant, checker and image textures,
normal maps) under area, point, distant and environment lights, with the
Sobol sampler and both MIS modes ("ref" and "onesample"). Camera rays
carry ray differentials when the scene binds a texture, so the first
hit's texture lookups filter by footprint. The bounce loop is a
Python loop over SoA wavefront state; PyTorch runs it eagerly. Every
closest-hit and shadow query goes to one of two kernels, as in the
reference: scenes of at most 128 triangles to the brute-force
``ops/cuda/intersect_cu.intersect`` (K1), larger ones to the BVH32
traversal ``ops/cuda/bvhw_cu.bvhw_intersect`` (K2) over the table that
``TracedScene.create`` builds. Each wrapper launches its kernel for CUDA
tensors and runs its plain version for CPU tensors.

Left out, as they exist only for the TPU: ``tuning.py``/``tuned.json``,
the wavefront sort, the one-hot MXU row gather (``table[idx]`` here), the
lane-bounce budget, the segmented renderer and the traversal's chunk and
interleave knobs. Alpha masks, checkpoints, other samplers and the
all-lights strategy raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import math as pm
from .core.camera import Camera, generate_rays, generate_rays_diff
from .core.filter import filter_f1d as make_filter_f1d
from .accel.bvh import build_bvh
from .accel.bvhw import STACKW, bvhw_from_binary
from .core.film import (film_crop, film_pad_accumulate, film_pad_new,
                        sample_bounds, splat_halfwidth, splat_tile)
from .ops import bsdf as bx
from .ops import interaction as ia
from .ops import lights as lt
from .ops import sobol as sb
from .ops.cuda.bvhw_cu import bvhw_intersect
from .ops.cuda.intersect_cu import intersect
from .scene.scene import (LIGHT_AREA, MAT_GLASS, MAT_MATTE, MAT_MIRROR,
                          SceneData, pack_light_attr, pack_mat_attr,
                          pack_tri_attr, reorder_triangles)

_ITEM_3 = "ROADMAP Queue 1 item 3 (10b-ii: the alpha path, then the " \
    "Sponza film)"

# static per-bounce dimension layout (after camera dims 0,1)
DIMS_PER_BOUNCE = 8
DIM_U_LIGHT = 0
DIM_U_SCATTER = 2
DIM_LIGHT_PICK = 4
DIM_BSDF = 5
DIM_RR = 7

# rays per wave: one row band of the sample rectangle
WAVE_LANES = 1 << 17


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Integrator knobs (same fields and defaults as the reference)."""

    max_depth: int = 15
    rr_threshold: float = 1.0
    rr_start_depth: int = 3
    rr_enable: bool = True
    sanitize: bool = True  # zero non-finite radiance
    sampler: str = "sobol"
    light_strategy: str = "one"
    count_occupancy: bool = False
    # "ref": estimate_direct's BSDF branch re-intersects the scene;
    # "onesample": the continuation ray doubles as the MIS BSDF branch
    mis_mode: str = "ref"


def _check_config(cfg: PathConfig) -> None:
    if cfg.sampler != "sobol":
        raise NotImplementedError(
            f"sampler {cfg.sampler!r}: ROADMAP Queue 1 item 11 "
            "(other samplers)")
    if cfg.light_strategy != "one":
        raise NotImplementedError(
            f"light_strategy {cfg.light_strategy!r}: ROADMAP Queue 1 item "
            "11 (other samplers and the all-lights strategy)")
    if cfg.count_occupancy:
        raise NotImplementedError(
            "count_occupancy: ROADMAP Queue 1 item 14 (frontends and "
            "profiling counters)")
    if cfg.mis_mode not in ("ref", "onesample"):
        raise ValueError(f"unknown mis_mode {cfg.mis_mode!r}")


@dataclasses.dataclass(frozen=True)
class TracedScene:
    """SceneData plus the packed tables the hot path reads, on one device.

    tri_attr / light_attr / mat_attr are the packed per-row attribute
    matrices (scene/scene.py pack_*); tri_pack is the (F, 12) [p0 p1 p2
    pad] table K1 reads. Scenes above 128 triangles also carry the BVH32
    table ``bw_rows`` (R, 256) that K2 reads, and its depth ``bw_depth``;
    their ``data`` is in BVH leaf order. The static flags say which
    material types, light types, texture channels (kd, ks, metallic,
    roughness), image textures, normal maps and environment the bounce
    has to evaluate.
    """

    data: SceneData
    tri_attr: torch.Tensor
    light_attr: torch.Tensor
    mat_attr: torch.Tensor
    tri_pack: torch.Tensor
    mat_set: tuple = (MAT_MATTE,)
    n_lights: int = 1
    light_set: tuple = (LIGHT_AREA,)
    bw_rows: torch.Tensor | None = None
    bw_depth: int = STACKW
    has_tex: bool = False
    tex_channels: tuple = (False, False, False, False)
    image_tex: bool = False
    has_normal_maps: bool = False
    has_env: bool = False

    @property
    def device(self) -> torch.device:
        return self.tri_pack.device

    @staticmethod
    def create(sd: SceneData, use_bvh: bool | None = None,
               max_leaf: int = 4) -> "TracedScene":
        """Pack the scene on its own device. With ``use_bvh`` (by default
        above 128 triangles, the reference's rule) it takes the BVH route,
        kernel K2: the binary SAH build, the triangles reordered into its
        leaf order, and the 32-wide collapse. Without it, the brute-force
        route, kernel K1, which takes any number of triangles."""
        if use_bvh is None:
            use_bvh = int(sd.p0.shape[0]) > 128
        if not use_bvh:
            return TracedScene.from_tables(sd)
        _check_scene(sd)  # before the build, not only after it
        bvh = build_bvh(sd.p0.cpu().numpy(), sd.p1.cpu().numpy(),
                        sd.p2.cpu().numpy(), max_leaf)
        sd = reorder_triangles(sd, bvh.order)
        table, depth = bvhw_from_binary(
            bvh, sd.p0.cpu().numpy(), sd.p1.cpu().numpy(),
            sd.p2.cpu().numpy())
        return TracedScene.from_tables(sd, table, depth)

    @staticmethod
    def from_tables(sd: SceneData, bw_rows=None,
                    bw_depth: int = STACKW) -> "TracedScene":
        """Pack a scene whose triangles are already in the order of the
        BVH32 table ``bw_rows`` (a host array; None for the
        brute-force route)."""
        _check_scene(sd)
        device = sd.device
        sd = dataclasses.replace(sd, tex=sd.tex.to(device))
        f = int(sd.p0.shape[0])
        n_lights = int(sd.n_lights)
        used = np.unique(sd.material_id.cpu().numpy())

        def t(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        bound = [tx.cpu().numpy()[used]
                 for tx in (sd.mat_kd_tx, sd.mat_ks_tx, sd.mat_metallic_tx,
                            sd.mat_rough_tx)]
        tex_channels = tuple(bool((tx >= 0).any()) for tx in bound)
        kind = sd.txd_kind.cpu().numpy()
        image_tex = any(bool((kind[tx[tx >= 0]] == 2).any()) for tx in bound)
        p = [sd.p0.cpu().numpy(), sd.p1.cpu().numpy(), sd.p2.cpu().numpy()]
        tri_pack = np.concatenate(p + [np.zeros((f, 3), np.float32)], axis=1)
        return TracedScene(
            data=sd, tri_attr=t(pack_tri_attr(sd)),
            light_attr=t(pack_light_attr(sd)), mat_attr=t(pack_mat_attr(sd)),
            tri_pack=t(tri_pack),
            mat_set=tuple(sorted(set(
                sd.mat_type.cpu().numpy()[used].tolist()))),
            n_lights=n_lights,
            light_set=tuple(sorted(set(
                sd.light_type.cpu().numpy().tolist())))
            if n_lights > 0 else (),
            bw_rows=None if bw_rows is None
            else t(bw_rows).contiguous(),
            bw_depth=int(bw_depth), has_tex=any(tex_channels),
            tex_channels=tex_channels, image_tex=image_tex,
            has_normal_maps=bool(
                (sd.mat_normal_tx.cpu().numpy()[used] >= 0).any()),
            has_env=bool(sd.has_env))


def _check_scene(sd: SceneData) -> None:
    """Raise NotImplementedError for what the port does not render yet:
    alpha masks."""
    if bool((sd.tri_alpha_txd >= 0).any()):
        raise NotImplementedError(f"alpha masks: {_ITEM_3}")


def _lane_bounds(o, t_max, live):
    """Each lane's t_max as an (N,) tensor: ``t_max`` ((N,), or one float
    for every lane) on the lanes of ``live`` ((N,) bool; None: all), 0 on
    the others. Both kernels test nothing for a lane whose t_max is not
    > 0 and report it a miss, as the plain versions do."""
    if live is not None:
        return torch.where(live, t_max, 0.0)
    if isinstance(t_max, float):
        return torch.full((o.shape[0],), t_max, device=o.device)
    return t_max.contiguous()


def _scene_intersect(scene, o, d, t_max, live=None):
    """Closest hit of every lane (K2 on the BVH route, K1 otherwise);
    lanes outside ``live`` get a miss (``_lane_bounds``)."""
    o, d, t_max = o.contiguous(), d.contiguous(), _lane_bounds(o, t_max, live)
    if scene.bw_rows is not None:
        return bvhw_intersect(scene.bw_rows, o, d, t_max,
                              stackw=scene.bw_depth)
    return intersect(o, d, t_max, scene.tri_pack)


def _scene_intersect_p(scene, o, d, t_max, live=None):
    """Any hit of every lane within t_max; lanes outside ``live`` report
    none."""
    o, d, t_max = o.contiguous(), d.contiguous(), _lane_bounds(o, t_max, live)
    if scene.bw_rows is not None:
        return bvhw_intersect(scene.bw_rows, o, d, t_max, any_hit=True,
                              stackw=scene.bw_depth)
    return intersect(o, d, t_max, scene.tri_pack, any_hit=True)


def _to_local(it, w):
    return torch.stack([pm.dot(w, it["ss"]), pm.dot(w, it["ts"]),
                        pm.dot(w, it["ns"])], dim=-1)


def _to_world(it, w):
    return (w[..., 0:1] * it["ss"] + w[..., 1:2] * it["ts"]
            + w[..., 2:3] * it["ns"])


def _reflect_ng_fn(it, wo_world):
    """The geometric-normal reflection test of a local wi: (wi.ng)(wo.ng)
    > 0 in world space."""
    return lambda wi_loc: (pm.dot(_to_world(it, wi_loc), it["ng"])
                           * pm.dot(wo_world, it["ng"])) > 0.0


def estimate_direct(scene, cfg, it, mp, u_scatt, u_light, light_idx,
                    wo_world, bsdf_branch=True, pick_prob=1.0, live=None):
    """Both-strategy MIS direct lighting for one chosen light per ray.

    Returns (N, 3) radiance (pre num_lights scaling). With
    ``bsdf_branch=False`` ("onesample") only the light-sample branch runs
    and ``pick_prob`` folds into the light pdf. ``live`` ((N,) bool, None
    for all) marks the lanes whose result the caller keeps: a ray of a
    lane outside it, or of a branch whose term is zero, tests nothing.
    """
    sd = scene.data
    light_rows = scene.light_attr[light_idx.long()]
    ls = lt.sample_li(sd, light_rows, it["p"], it["p_error"], it["ng"],
                      u_light, light_set=scene.light_set)
    wi = ls["wi"]
    pdf_eff = ls["pdf"] * pick_prob

    # --- light-sample branch
    wo_l = _to_local(it, wo_world)
    wi_l = _to_local(it, wi)
    reflect_ng = (pm.dot(wi, it["ng"]) * pm.dot(wo_world, it["ng"])) > 0.0
    f, scatt_pdf = bx.eval_f_pdf(mp, wo_l, wi_l, reflect_ng,
                                 present=scene.mat_set)
    f = f * torch.abs(pm.dot(wi, it["ns"]))[..., None]

    branch1 = (ls["pdf"] > 0.0) & torch.any(ls["li"] != 0.0, dim=-1) & \
        torch.any(f != 0.0, dim=-1)
    so, sdir, st = ia.spawn_ray_to(it["p"], it["p_error"], it["ng"],
                                   ls["target_p"], ls["target_err"],
                                   ls["target_n"])
    w1 = torch.where(ls["is_delta"], 1.0,
                     pm.power_heuristic(1.0, pdf_eff, 1.0, scatt_pdf))
    li1u = torch.where(branch1[..., None], ls["li"], 0.0)
    contrib1 = f * li1u * w1[..., None] / \
        torch.clamp_min(pdf_eff, 1e-20)[..., None]
    contrib1 = torch.where(branch1[..., None], contrib1, 0.0)
    occluded = _scene_intersect_p(
        scene, so, sdir, st, live=branch1 if live is None else live & branch1)
    ld = torch.where(occluded[..., None], 0.0, contrib1)
    if not bsdf_branch:
        return ld

    # --- BSDF-sample branch, non-delta lights only
    bs = bx.sample_f(mp, wo_l, u_scatt, _reflect_ng_fn(it, wo_world),
                     present=scene.mat_set)
    wi2_w = _to_world(it, bs["wi"])
    f2 = bs["f"] * torch.abs(pm.dot(wi2_w, it["ns"]))[..., None]
    branch2 = (~ls["is_delta"]) & torch.any(f2 != 0.0, dim=-1) & \
        (bs["pdf"] > 0.0)
    light_pdf2 = lt.pdf_li(sd, light_rows, it["p"], it["p_error"], it["ng"],
                           wi2_w, light_set=scene.light_set)
    w2 = pm.power_heuristic(1.0, bs["pdf"], 1.0, light_pdf2)
    branch2 = branch2 & (light_pdf2 > 0.0)

    o2 = ia.spawn_ray(it["p"], it["p_error"], it["ng"], wi2_w)
    hit2 = _scene_intersect(
        scene, o2, wi2_w, torch.inf,
        live=branch2 if live is None else live & branch2)
    li2_hit, hit_tri_light = ia.hit_emission(scene.tri_attr, hit2, -wi2_w)
    hit_the_light = hit2["valid"] & (hit_tri_light == light_idx) & \
        ls["is_area"]
    li2 = torch.where(hit_the_light[..., None], li2_hit, 0.0)
    if scene.has_env:
        li2_env = torch.where((ls["is_env"] & ~hit2["valid"])[..., None],
                              lt.env_le(sd, wi2_w), 0.0)
        li2 = torch.where(hit_the_light[..., None], li2, li2_env)
    contrib2 = f2 * li2 * w2[..., None] / \
        torch.clamp_min(bs["pdf"], 1e-20)[..., None]
    return ld + torch.where(branch2[..., None], contrib2, 0.0)


def trace_wave(scene, cfg: PathConfig, draw, draw2, o, d, rxd=None,
               ryd=None, lane_valid=None):
    """Trace one wavefront of rays to completion.

    draw(dim) / draw2(dim) give one / two sampler dimensions for the whole
    wave; rxd / ryd are the camera rays' differential directions (None:
    none), used at the first hit only. Returns (L (N, 3), ray count,
    non-finite sample count), the two counts as 0-d tensors.
    """
    st = _wave_init(scene, cfg, o, d, lane_valid=lane_valid)
    for bounce in range(cfg.max_depth + 1):
        st = _wave_bounce(scene, cfg, bounce, st, draw, draw2,
                          rxd=rxd if bounce == 0 else None,
                          ryd=ryd if bounce == 0 else None)
    out, n_bad = _wave_radiance(cfg, st)
    return out, st["rays"], n_bad


def _wave_flags(scene, cfg):
    """Static wave configuration derived from scene + cfg:
    (do_nee, one_sample, pick_prob)."""
    any_nonspec = any(m not in (MAT_MIRROR, MAT_GLASS) for m in scene.mat_set)
    do_nee = any_nonspec and scene.n_lights > 0
    one_sample = cfg.mis_mode == "onesample" and do_nee
    pick_prob = 1.0 / max(scene.n_lights, 1)
    return do_nee, one_sample, pick_prob


def _wave_init(scene, cfg, o, d, lane_valid=None):
    """Fresh wavefront state for a wave of camera rays. lane_valid (N,)
    bool marks real lanes; the rest start inactive."""
    n = o.shape[0]
    dev = o.device
    _, one_sample, _ = _wave_flags(scene, cfg)
    active0 = torch.ones((n,), dtype=torch.bool, device=dev) \
        if lane_valid is None else lane_valid.reshape(n)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return dict(
        o=o, d=d, l=zeros(n, 3),
        beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
        active=active0,
        # onesample: "specular" doubles as bounce-0 full-weight Le
        specular=torch.full((n,), one_sample, dtype=torch.bool, device=dev),
        eta_scale=torch.ones((n,), dtype=torch.float32, device=dev),
        prev_pdf=zeros(n), prev_p=o, prev_perr=zeros(n, 3),
        prev_ng=zeros(n, 3), rays=zeros(),
    )


def _wave_radiance(cfg, st):
    """Final radiance + count of non-finite / negative samples."""
    out = st["l"]
    bad = ~torch.isfinite(out) | (out < -1e-5)
    n_bad = torch.sum(torch.any(bad, dim=-1).to(torch.float32))
    if cfg.sanitize:
        out = torch.where(torch.isfinite(out), out, 0.0)
    return out, n_bad


def _wave_bounce(scene, cfg, bounce, st, draw, draw2, rxd=None, ryd=None):
    """ONE wavefront bounce: intersect, Le, NEE, BSDF sample, RR. rxd /
    ryd: the camera rays' differential directions (bounce 0 only)."""
    sd = scene.data
    do_nee, one_sample, pick_prob = _wave_flags(scene, cfg)
    last = bounce == cfg.max_depth
    dim_base = 2 + DIMS_PER_BOUNCE * bounce

    st = dict(st)
    o, d = st["o"], st["d"]
    n = o.shape[0]
    l, beta, active = st["l"], st["beta"], st["active"]
    specular = st["specular"]
    prev_pdf, prev_p = st["prev_pdf"], st["prev_p"]
    prev_perr, prev_ng = st["prev_perr"], st["prev_ng"]

    st["rays"] = st["rays"] + torch.sum(active.to(torch.float32))
    # finished paths test nothing: t_max 0 on the lanes not active
    hit = _scene_intersect(scene, o, d, torch.inf, live=active)
    found = hit["valid"] & active

    # emitted radiance. "ref": camera/specular bounces only; "onesample":
    # every vertex, MIS-weighted against the previous vertex's
    # light-sampling density
    le_mask = active if bounce == 0 else (active & specular)
    if last:
        # only Le survives the final bounce: skip the frame build
        le_hit, hl = ia.hit_emission(scene.tri_attr, hit, -d)
    else:
        it = ia.make_interaction(sd, o, d, hit, scene.tri_attr)
        # the camera rays' differentials -> UV derivatives for the mip
        # filter width; rays past the first hit carry none
        duv = ia.compute_duv(it, o, rxd, ryd) \
            if (bounce == 0 and rxd is not None) else None
        if scene.has_normal_maps:
            it = ia.apply_normal_mapping(sd, it, duv=duv)
        le_hit = ia.emitted_radiance(it, -d)
        hl = it["area_light"]
    if one_sample:
        if bounce == 0 or LIGHT_AREA not in scene.light_set:
            w_area = torch.ones((n,), dtype=torch.float32, device=o.device)
        else:
            lrows_h = scene.light_attr[torch.clamp_min(hl, 0).long()]
            lpdf = lt.pdf_li(sd, lrows_h, prev_p, prev_perr, prev_ng, d,
                             light_set=(LIGHT_AREA,)) * pick_prob
            w_area = torch.where(specular, 1.0,
                                 pm.power_heuristic(1.0, prev_pdf, 1.0, lpdf))
        l = l + torch.where((active & found)[..., None],
                            beta * le_hit * w_area[..., None], 0.0)
    else:
        l = l + torch.where((le_mask & found)[..., None], beta * le_hit, 0.0)
    if scene.has_env:
        # escaped rays see the environment, MIS-weighted in "onesample"
        # against the previous vertex's light-sampling density
        le_env = lt.env_le(sd, d)
        if one_sample:
            if bounce == 0:
                w_env = torch.ones((n,), dtype=torch.float32, device=o.device)
            else:
                epdf = lt.env_pdf_li(sd, d) * pick_prob
                w_env = torch.where(specular, 1.0,
                                    pm.power_heuristic(1.0, prev_pdf, 1.0,
                                                       epdf))
            l = l + torch.where((active & ~hit["valid"])[..., None],
                                beta * le_env * w_env[..., None], 0.0)
        else:
            l = l + torch.where((le_mask & ~hit["valid"])[..., None],
                                beta * le_env, 0.0)
    if last:
        st["l"] = l
        return st

    cont = found
    mp = bx.gather_params(sd, it["material"], it["uv"], scene.mat_attr,
                          has_tex=scene.has_tex, duv=duv,
                          tex_channels=scene.tex_channels,
                          image_tex=scene.image_tex)
    wo = -d

    # --- NEE for materials with non-specular lobes
    rays = st["rays"]
    if do_nee:
        nonspec = bx.has_nonspecular(mp["mtype"]) & cont
        shadow_rays = 1.0 if one_sample else 2.0
        u_light = draw2(dim_base + DIM_U_LIGHT)
        u_scatt = None if one_sample else draw2(dim_base + DIM_U_SCATTER)
        n_l = float(np.float32(scene.n_lights))
        if scene.n_lights > 1:
            u_pick = draw(dim_base + DIM_LIGHT_PICK)
            light_idx = torch.clamp_max((u_pick * n_l).to(torch.int32),
                                        scene.n_lights - 1)
        else:
            light_idx = torch.zeros((n,), dtype=torch.int32, device=o.device)
        ld = estimate_direct(scene, cfg, it, mp, u_scatt, u_light, light_idx,
                             wo, bsdf_branch=not one_sample,
                             pick_prob=pick_prob if one_sample else 1.0,
                             live=nonspec)
        scale = 1.0 if one_sample else n_l
        l = l + torch.where(nonspec[..., None], beta * ld * scale, 0.0)
        rays = rays + shadow_rays * torch.sum(nonspec.to(torch.float32))
    st["rays"] = rays

    # --- BSDF sampling for the next bounce
    u_bsdf = draw2(dim_base + DIM_BSDF)
    wo_l = _to_local(it, wo)
    bs = bx.sample_f(mp, wo_l, u_bsdf, _reflect_ng_fn(it, wo),
                     present=scene.mat_set)
    wi_w = _to_world(it, bs["wi"])
    cos_ns = torch.abs(pm.dot(wi_w, it["ns"]))
    dead = torch.all(bs["f"] == 0.0, dim=-1) | (bs["pdf"] == 0.0)
    new_beta = beta * bs["f"] * \
        (cos_ns / torch.clamp_min(bs["pdf"], 1e-20))[..., None]
    cont2 = cont & ~dead
    beta = torch.where(cont2[..., None], new_beta, beta)
    st["specular"] = torch.where(cont2, bs["specular"], specular)
    if one_sample:
        # next vertex's MIS weight needs this vertex's sampling state
        st["prev_pdf"] = torch.where(cont2, bs["pdf"], prev_pdf)
        st["prev_p"] = torch.where(cont2[..., None], it["p"], prev_p)
        st["prev_perr"] = torch.where(cont2[..., None], it["p_error"],
                                      prev_perr)
        st["prev_ng"] = torch.where(cont2[..., None], it["ng"], prev_ng)

    # eta_scale for Russian roulette through glass: only specular
    # transmission moves it off 1
    if MAT_GLASS in scene.mat_set and cfg.rr_enable:
        spec_trans = bs["specular"] & bs["transmission"]
        eta = mp["eta"]
        scale = torch.where(pm.dot(wo, it["ng"]) > 0.0, eta * eta,
                            1.0 / torch.clamp_min(eta * eta, 1e-20))
        st["eta_scale"] = torch.where(cont2 & spec_trans,
                                      st["eta_scale"] * scale,
                                      st["eta_scale"])

    new_o = ia.spawn_ray(it["p"], it["p_error"], it["ng"], wi_w)
    st["o"] = torch.where(cont2[..., None], new_o, o)
    st["d"] = torch.where(cont2[..., None], wi_w, d)

    # --- Russian roulette (off below the start depth)
    if cfg.rr_enable and bounce > cfg.rr_start_depth:
        rr_beta_max = torch.amax(beta * st["eta_scale"][..., None], dim=-1)
        rr_gate = cont2 & (rr_beta_max < cfg.rr_threshold)
        u_rr = draw(dim_base + DIM_RR)
        q = torch.clamp_min(1.0 - rr_beta_max, 0.05)
        rr_kill = rr_gate & (u_rr < q)
        beta = torch.where((rr_gate & ~rr_kill)[..., None],
                           beta / (1.0 - q)[..., None], beta)
        cont2 = cont2 & ~rr_kill

    st["l"] = l
    st["beta"] = beta
    st["active"] = cont2
    return st


def render_band(scene, cfg: PathConfig, spp: int, band_shape: tuple[int, int],
                valid_lanes, film_pad, band_x0: int, band_y0: int, px, py,
                b_base, scramble, frame_lo, frame_hi, frame_delta,
                inv_lo, inv_hi, r2c, cam_rot, cam_pos, filter_f1d,
                sobol_pack, sobol_scale: float, sobol_off_x: float,
                sobol_off_y: float, filter_radius: float = 2.0,
                dxdy_cam=None, diff_scale: float = 1.0):
    """Render ``spp`` sampler frames for one row band into the padded film
    (in place). Returns (film_pad, ray count, non-finite count).

    band_shape = (Th, Tw); px/py: (Th*Tw,) absolute pixel coords;
    valid_lanes: (Th*Tw,) bool (padding rows carry zero weight); b_base /
    scramble: (Th*Tw,) int64 Sobol words; frame_*: host per-frame Sobol
    constants (sobol.frame_statics); dxdy_cam: the camera's (2, 3)
    raster-step offsets (Camera.diff_params) that turn on ray
    differentials where the scene binds a texture or normal map, None for
    none; diff_scale: their scale, 1/sqrt(spp) of the whole render.
    """
    _check_config(cfg)
    th, tw = band_shape
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    valid = valid_lanes.reshape(th, tw)
    rays_total = torch.zeros((), device=px.device)
    bad_total = torch.zeros((), device=px.device)
    for s in range(spp):
        idx_lo, idx_hi = sb.sobol_index(b_base, frame_delta[s], frame_lo[s],
                                        frame_hi[s], inv_lo, inv_hi)

        def draw(dim):
            return sb.sobol_sample_dim(idx_lo, idx_hi, dim, scramble,
                                       sobol_pack)

        def draw2(dim):
            return sb.sobol_sample_dim2(idx_lo, idx_hi, dim, scramble,
                                        sobol_pack)

        # camera dims 0,1 remapped into the pixel, drawn UNSCRAMBLED (as
        # the reference and PBRT's SobolSampler do)
        s01 = sb.sobol_sample_dim2(idx_lo, idx_hi, 0,
                                   torch.zeros_like(scramble), sobol_pack)
        one_minus = float(pm.ONE_MINUS_EPSILON)
        jx = torch.clamp(s01[..., 0] * sobol_scale + sobol_off_x - pxf,
                         0.0, one_minus)
        jy = torch.clamp(s01[..., 1] * sobol_scale + sobol_off_y - pyf,
                         0.0, one_minus)
        p_film = torch.stack([pxf + jx, pyf + jy], dim=-1)
        if dxdy_cam is not None and (scene.has_tex or scene.has_normal_maps):
            o, d, rxd, ryd = generate_rays_diff(r2c, cam_rot, cam_pos,
                                                p_film, dxdy_cam, diff_scale)
        else:
            o, d = generate_rays(r2c, cam_rot, cam_pos, p_film)
            rxd = ryd = None
        radiance, rays, n_bad = trace_wave(scene, cfg, draw, draw2, o, d,
                                           rxd, ryd, lane_valid=valid_lanes)
        tile = splat_tile(radiance.reshape(th, tw, 3), jx.reshape(th, tw),
                          jy.reshape(th, tw), valid, filter_f1d,
                          radius=filter_radius)
        film_pad = film_pad_accumulate(film_pad, tile, band_x0, band_y0,
                                       half=splat_halfwidth(filter_radius))
        rays_total = rays_total + rays
        bad_total = bad_total + n_bad
    return film_pad, rays_total, bad_total


class PathIntegrator:
    """Host-side render loop: builds the sample-bounds pixel grid, cuts it into
    row bands of about WAVE_LANES rays, and renders each band.

    ``no_diff`` turns the camera rays' differentials off, so every texture
    lookup takes level 0: the reference's environment switch
    ``PTPU_NO_DIFF``, here an explicit argument (ROADMAP Queue 3)."""

    def __init__(self, cfg: PathConfig = PathConfig(), spp: int = 4,
                 filter_kind: str = "gaussian", band_rows: int | None = None,
                 no_diff: bool = False):
        _check_config(cfg)
        self.cfg = cfg
        self.no_diff = no_diff
        self.spp = pm.round_up_pow2(spp)
        f1d, self.filter_radius = make_filter_f1d(filter_kind)
        self.filter_f1d = tuple(float(v) for v in f1d)
        self.band_rows = band_rows
        self.last_ray_count = 0.0
        self.bad_sample_count = 0.0

    def render(self, camera: Camera, scene) -> torch.Tensor:
        """Returns the (H, W, 4) film accumulator on the scene's device."""
        return self.render_progressive(camera, scene, chunk_spp=self.spp)

    def band_layout(self, camera: Camera) -> tuple[int, int]:
        """(rows per band, number of bands) for this camera."""
        w, h = camera.resolution
        (x0, y0), (x1, y1) = sample_bounds(w, h, self.filter_radius)
        ws, hs = x1 - x0, y1 - y0
        band = min(self.band_rows or max(1, WAVE_LANES // ws), hs)
        return band, -(-hs // band)

    def render_progressive(self, camera: Camera, scene,
                           chunk_spp: int | None = None, callback=None,
                           checkpoint: str | None = None) -> torch.Tensor:
        """Render in sample-index chunks, calling ``callback(film, done)``
        after each chunk with the (H, W, 4) film so far. ``checkpoint``
        (saving and resuming the film) is not ported yet and raises."""
        if checkpoint is not None:
            raise NotImplementedError(f"checkpoint: {_ITEM_3}")
        if not isinstance(scene, TracedScene):
            scene = TracedScene.create(scene)
        dev = scene.device
        self.last_ray_count = 0.0
        self.bad_sample_count = 0.0
        w, h = camera.resolution
        (x0, y0), (x1, y1) = sample_bounds(w, h, self.filter_radius)
        ws = x1 - x0
        domain = sb.SobolDomain.create((x0, y0), (x1, y1), self.spp)
        band, n_bands = self.band_layout(camera)
        chunk = pm.round_up_pow2(min(chunk_spp or self.spp, self.spp))

        inv_lo, inv_hi = sb.vdc_inv_rows(domain, dev)
        sobol_pack = sb.sm32_device(dev)
        r2c, cam_rot, cam_pos = camera.ray_params(dev)
        diff = not self.no_diff and (scene.has_tex or scene.has_normal_maps)
        dxdy_cam = camera.diff_params(dev) if diff else None
        diff_scale = float(np.float32(1.0 / np.sqrt(self.spp)))
        film_pad = film_pad_new(w, h, extra_rows=band, device=dev)

        # per-band pixel statics (host, once)
        bands = []
        for bi in range(n_bands):
            by0 = y0 + bi * band
            xs, ys = np.meshgrid(np.arange(x0, x1),
                                 np.arange(by0, by0 + band), indexing="xy")
            px = xs.ravel().astype(np.int32)
            py = ys.ravel().astype(np.int32)
            scramble, b_base = sb.pixel_statics(domain, px,
                                                np.minimum(py, y1 - 1))

            def t(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
            bands.append((by0, t(px, torch.int32), t(py, torch.int32),
                          t(py < y1, torch.bool),
                          t(b_base.astype(np.int64), torch.int64),
                          t(scramble.astype(np.int64), torch.int64)))

        for s0 in range(0, self.spp, chunk):
            n_frames = min(chunk, self.spp - s0)
            frames = [sb.frame_statics(domain, s0 + i)
                      for i in range(n_frames)]
            frame_lo = [int(f[0]) for f in frames]
            frame_hi = [int(f[1]) for f in frames]
            frame_delta = [int(f[2]) for f in frames]
            stats = []  # device scalars; one sync per chunk, not per band
            for by0, px, py, valid, b_base, scramble in bands:
                film_pad, rays, n_bad = render_band(
                    scene, self.cfg, n_frames, (band, ws), valid, film_pad,
                    x0, by0, px, py, b_base, scramble, frame_lo, frame_hi,
                    frame_delta, inv_lo, inv_hi, r2c, cam_rot, cam_pos,
                    self.filter_f1d, sobol_pack,
                    float(np.float32(domain.resolution)),
                    float(np.float32(domain.p_min[0])),
                    float(np.float32(domain.p_min[1])),
                    filter_radius=self.filter_radius, dxdy_cam=dxdy_cam,
                    diff_scale=diff_scale)
                stats.append((rays, n_bad))
            for rays, n_bad in stats:
                self.last_ray_count += float(rays)
                self.bad_sample_count += float(n_bad)
            if callback is not None:
                callback(film_crop(film_pad, w, h), s0 + n_frames)
        return film_crop(film_pad, w, h)
