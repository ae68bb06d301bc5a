"""Wavefront path integrator: NEE + MIS + Russian roulette, fully batched.

Port of ``pathtracer_tpu/integrator.py`` in its fused form, for opaque
scenes of every material model (constant, checker and image textures,
normal maps) under area, point, distant and environment lights, with the
Sobol, stratified and random samplers, one light or all lights a vertex,
and both MIS modes ("ref" and "onesample"). Camera rays
carry ray differentials when the scene binds a texture, so the first
hit's texture lookups filter by footprint. The bounce loop is a
Python loop over SoA wavefront state; PyTorch runs it eagerly, or, on a
card where a band-frame asks nothing of the host (``_graph_engages``),
captures one band-frame as a CUDA graph and replays it for every band
and frame of that shape (``_BandGraph``). Every
closest-hit and shadow query goes to one of two kernels, as in the
reference: scenes of at most 128 triangles to the brute-force
``ops/cuda/intersect_cu.intersect`` (K1), larger ones to the BVH32
traversal ``ops/cuda/bvhw_cu.bvhw_intersect`` (K2) over the table that
``TracedScene.create`` builds. Each wrapper launches its kernel for CUDA
tensors and runs its plain version for CPU tensors.

Alpha masks (cutouts) take the reference's routes. On the BVH route the
masked triangles leave the main table: after the main tree's hit, the
alpha subset is intersected up to that hit's t, through a BVH32 table of
its own (K2, above 512 masked triangles) with re-spawn retries past
zero-alpha texels (``_alpha_cut``), or densely below
(``ops/intersect.intersect_alpha_dense``). A scene whose every triangle is
masked keeps the binary tree and tests the masks inline
(``accel/bvh.bvh_intersect``). On the brute-force route (K1) the retries
wrap every query. Each retry loop ends early, at one host sync a pass
(``RETRY_COUNTS``). ``render_progressive`` saves and resumes the film in
the reference's checkpoint file.

Left out, as they exist only for the TPU: ``tuning.py``/``tuned.json``,
the wavefront sort, the one-hot MXU row gather (``table[idx]`` here), the
lane-bounce budget, the segmented renderer and the traversal's chunk and
interleave knobs.

Each band-frame counts its live lanes a bounce (``trace_wave``'s
``occupancy``) into a (max_depth + 1,) float64 tensor of the render's on
the device, which the host reads at each chunk's sync into
``PathIntegrator.bounce_occupancy`` and ``PathIntegrator.lane_bounces``.
In a scene with an environment the tensor holds one entry more: the live
lanes whose environment result enters the estimate, which the same read
takes into ``PathIntegrator.env_lanes``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .core import math as pm
from .core.camera import Camera, generate_rays, generate_rays_diff
from .core.filter import filter_f1d as make_filter_f1d
from .accel.bvh import (_alpha_test_inline, _pack_nodes, build_bvh,
                        bvh_intersect)
from .accel.bvhw import STACKW, build_bvhw, bvhw_from_binary
from .core.film import (film_crop, film_pad_accumulate, film_pad_new,
                        sample_bounds, splat_halfwidth, splat_tile)
from .ops import bsdf as bx
from .ops import interaction as ia
from .ops import lights as lt
from .ops import samplers as smp
from .ops import sobol as sb
from .ops.cuda.bvhw_cu import bvhw_intersect
from .ops.cuda import _build, bsdf_cu, sobol_cu, texture_cu
from .ops.cuda.intersect_cu import intersect
from .ops.intersect import GAMMA7, intersect_alpha_dense
from .utils.span_graph import SpanGraph
from .utils.spans import span
from .scene.scene import (LIGHT_AREA, LIGHT_INFINITE, MAT_GLASS, MAT_MATTE,
                          MAT_MIRROR, TA_ALPHA, TA_NG0, TA_P0, TA_P1, TA_P2,
                          TA_UV0, TA_UV1, TA_UV2, SceneData, pack_alpha_tri,
                          pack_light_attr, pack_mat_attr, pack_tri_attr,
                          reorder_triangles)

# static per-bounce dimension layout (after camera dims 0,1)
DIMS_PER_BOUNCE = 8
DIM_U_LIGHT = 0
DIM_U_SCATTER = 2
DIM_LIGHT_PICK = 4
DIM_BSDF = 5
DIM_RR = 7
# light_strategy="all" takes up to this many lights (the reference's
# assert); each adds 4 sampler dims (u_light, u_scatter) a bounce
MAX_ALL_LIGHTS = 24

# rays per wave: one row band of the sample rectangle
WAVE_LANES = 1 << 17

# the alpha split (the reference's rules): above DENSE_CAP masked
# triangles the subset is put in the order of its own SAH tree (the
# reference's byte bound of the dense pass, 768 MB of an (N x A) f32 grid
# at a 131,072-lane wave: 1,536); above ALPHA_TREE_MIN it is traced
# through a BVH32 table of its own
DENSE_CAP = min(4096, (768 << 20) // ((1 << 17) * 4))
ALPHA_TREE_MIN = 512
# re-spawn passes past zero-alpha texels: up to this many stacked cutout
# layers a ray; the next one reads as opaque (the reference's cap)
ALPHA_RETRIES = 3
# the alpha path's host work, summed over a process: "syncs", the host
# syncs of the retry loops' early exit (one each time a loop asks whether
# any lane is still cut); "passes", the retry traversals they ran;
# "alpha_tree", the queries of the alpha subset's BVH32 table (one K2
# launch each on the card)
RETRY_COUNTS = dict(syncs=0, passes=0, alpha_tree=0)
# band-frames over a process by how they ran: "captures", the first of a
# CUDA graph's key (run eagerly as the capture's warm-up, then captured);
# "replays", replays of a captured graph; "eager", the rest
# (``_graph_engages``)
GRAPH_COUNTS = dict(captures=0, replays=0, eager=0)
# the lanes the environment's code evaluates over a process, a call site's
# width each time the host issues it ("env.run": a capture tallies it and
# each replay adds the tally, as ``_build`` counts launches);
# ``PathIntegrator.env_lanes`` takes a render's share at each chunk's sync
ENV_RUN = 0
_build.counted(__name__, ("env.run",), attr="ENV_RUN")


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Integrator knobs (the reference's fields and defaults, but for its
    ``count_occupancy``: the port counts the live lanes always)."""

    max_depth: int = 15
    rr_threshold: float = 1.0
    rr_start_depth: int = 3
    rr_enable: bool = True
    sanitize: bool = True  # zero non-finite radiance
    sampler: str = "sobol"
    light_strategy: str = "one"
    # "ref": estimate_direct's BSDF branch re-intersects the scene;
    # "onesample": the continuation ray doubles as the MIS BSDF branch
    mis_mode: str = "ref"


def _check_config(cfg: PathConfig) -> None:
    if cfg.sampler not in ("sobol", "stratified", "random"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    if cfg.light_strategy not in ("one", "all"):
        raise ValueError(f"unknown light_strategy {cfg.light_strategy!r}")
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

    Alpha masks (``has_alpha``): on the BVH route with some triangles
    masked (``split_alpha``), the masked ones sit last, from ``n_opaque``
    on, and ``bw_rows`` covers the opaque ones; above 512 masked
    triangles ``bwa_rows`` (depth ``bwa_depth``) is the subset's own
    BVH32 table, whose triangle ids ``bwa_map`` turns into scene ids.
    With every triangle masked, ``bvh_nodes`` (M, 8) holds the binary
    tree (leaves of ``max_leaf``) and no BVH32 table is built. The BVH
    route's mask test reads ``alpha_pack`` (F, 16) and ``alpha_texels``
    (scene/scene.py pack_alpha_tri).
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
    has_alpha: bool = False
    split_alpha: bool = False
    n_opaque: int = -1
    alpha_pack: torch.Tensor | None = None
    alpha_texels: torch.Tensor | None = None
    bwa_rows: torch.Tensor | None = None
    bwa_map: torch.Tensor | None = None
    bwa_depth: int = STACKW
    bvh_nodes: torch.Tensor | None = None
    max_leaf: int = 4

    @property
    def device(self) -> torch.device:
        return self.tri_pack.device

    @property
    def use_bvh(self) -> bool:
        """Whether queries go through a tree (K2's table or the binary
        tree) rather than the brute-force K1."""
        return self.bw_rows is not None or self.bvh_nodes is not None

    @staticmethod
    def create(sd: SceneData, use_bvh: bool | None = None,
               max_leaf: int = 4) -> "TracedScene":
        """Pack the scene on its own device. With ``use_bvh`` (by default
        above 128 triangles, the reference's rule) it takes the BVH route:
        the binary SAH build, the triangles reordered into its leaf order,
        and the 32-wide collapse for kernel K2; masked triangles are split
        out (class docstring). Without it, the brute-force route, kernel
        K1, which takes any number of triangles."""
        f = int(sd.p0.shape[0])
        if use_bvh is None:
            use_bvh = f > 128
        if not use_bvh:
            return TracedScene.from_tables(sd)
        p0, p1, p2 = (x.cpu().numpy() for x in (sd.p0, sd.p1, sd.p2))
        amask = sd.tri_alpha_txd.cpu().numpy() >= 0
        n_alpha = int(amask.sum())
        if n_alpha == f:
            # every triangle masked: nothing to split out, the binary
            # tree with its inline mask test
            bvh = build_bvh(p0, p1, p2, max_leaf)
            nodes = _pack_nodes(bvh.bounds_min, bvh.bounds_max, bvh.offset,
                                bvh.n_prims, bvh.axis)
            return TracedScene.from_tables(
                reorder_triangles(sd, bvh.order), bvh_nodes=nodes,
                max_leaf=max_leaf)
        # the main tree over the opaque triangles; the masked ones last,
        # above DENSE_CAP in the order of their own SAH tree
        op_idx = np.nonzero(~amask)[0]
        al_idx = np.nonzero(amask)[0]
        n_op = len(op_idx)
        bvh = build_bvh(p0[op_idx], p1[op_idx], p2[op_idx], max_leaf)
        if n_alpha > DENSE_CAP:
            al_idx = al_idx[build_bvh(p0[al_idx], p1[al_idx], p2[al_idx],
                                      max_leaf).order]
        sd = reorder_triangles(sd, np.concatenate([op_idx[bvh.order],
                                                   al_idx]))
        p0, p1, p2 = (x.cpu().numpy() for x in (sd.p0, sd.p1, sd.p2))
        table, depth = bvhw_from_binary(bvh, p0[:n_op], p1[:n_op],
                                        p2[:n_op])
        if n_alpha == 0:
            return TracedScene.from_tables(sd, table, depth)
        bwa_rows = bwa_map = None
        bwa_depth = STACKW
        if n_alpha > ALPHA_TREE_MIN:
            bwa_rows, order_a, bwa_depth = build_bvhw(
                p0[n_op:], p1[n_op:], p2[n_op:])
            bwa_map = np.asarray(n_op + order_a, np.int32)
        return TracedScene.from_tables(
            sd, table, depth, split_alpha=True, n_opaque=n_op,
            bwa_rows=bwa_rows, bwa_map=bwa_map, bwa_depth=bwa_depth)

    @staticmethod
    def from_tables(sd: SceneData, bw_rows=None, bw_depth: int = STACKW, *,
                    split_alpha: bool = False, n_opaque: int = -1,
                    bwa_rows=None, bwa_map=None, bwa_depth: int = STACKW,
                    bvh_nodes=None, max_leaf: int = 4) -> "TracedScene":
        """Pack a scene whose triangles are already in the order of its
        tables (host arrays): the BVH32 table ``bw_rows`` (None for the
        brute-force route and for the all-masked binary tree
        ``bvh_nodes``), and for a split alpha subset its table
        ``bwa_rows`` and id map ``bwa_map`` (class docstring)."""
        device = sd.device
        sd = dataclasses.replace(sd, tex=sd.tex.to(device))
        sd.txd_rows  # K3 / K4's descriptor rows, packed here at set-up
        f = int(sd.p0.shape[0])
        n_lights = int(sd.n_lights)
        used = np.unique(sd.material_id.cpu().numpy())

        def t(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        def opt(a, dtype=np.float32):
            return None if a is None else torch.as_tensor(
                np.array(a, dtype), device=device).contiguous()

        bound = [tx.cpu().numpy()[used]
                 for tx in (sd.mat_kd_tx, sd.mat_ks_tx, sd.mat_metallic_tx,
                            sd.mat_rough_tx)]
        tex_channels = tuple(bool((tx >= 0).any()) for tx in bound)
        kind = sd.txd_kind.cpu().numpy()
        image_tex = any(bool((kind[tx[tx >= 0]] == 2).any()) for tx in bound)
        p = [sd.p0.cpu().numpy(), sd.p1.cpu().numpy(), sd.p2.cpu().numpy()]
        tri_pack = np.concatenate(p + [np.zeros((f, 3), np.float32)], axis=1)
        # the mask-test rows follow the tree's triangle order (BVH route)
        a_pack, a_texels = pack_alpha_tri(sd) \
            if bw_rows is not None or bvh_nodes is not None else (None, None)
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
            bw_rows=opt(bw_rows), bw_depth=int(bw_depth),
            has_tex=any(tex_channels),
            tex_channels=tex_channels, image_tex=image_tex,
            has_normal_maps=bool(
                (sd.mat_normal_tx.cpu().numpy()[used] >= 0).any()),
            has_env=bool(sd.has_env),
            has_alpha=bool((sd.tri_alpha_txd >= 0).any()),
            split_alpha=bool(split_alpha), n_opaque=int(n_opaque),
            alpha_pack=opt(a_pack), alpha_texels=opt(a_texels),
            bwa_rows=opt(bwa_rows), bwa_map=opt(bwa_map, np.int32),
            bwa_depth=int(bwa_depth), bvh_nodes=opt(bvh_nodes),
            max_leaf=int(max_leaf))


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


def _any(mask) -> bool:
    """A retry loop's early-exit test: one host sync."""
    RETRY_COUNTS["syncs"] += 1
    return bool(mask.any())


def _select(cond, a, b):
    """Per-lane choice between two hit records."""
    return {key: torch.where(cond.reshape(cond.shape + (1,) * (a[key].dim()
                                                              - 1)),
                             a[key], b[key]) for key in b}


def _alpha_cut(scene, hit):
    """Lanes whose valid hit lands on a zero-alpha texel of a masked
    triangle: the mask through ``eval_texture`` at width 0 (its scale and
    sRGB included) at the interpolated uv, cut iff exactly 0. Returns
    (cut (N,) bool, p_hit, p_error, ng) for the re-spawn. Kernel K4 on
    the card (``ops/cuda/texture_cu.alpha_cut``), ``_alpha_cut_plain`` on
    the CPU."""
    with span("pt::alpha_cut"):
        return texture_cu.alpha_cut(scene, hit)


def _alpha_cut_plain(scene, hit):
    """The plain PyTorch version of K4 (``_alpha_cut``)."""
    rows = scene.tri_attr[hit["tri"].long()]
    txd = rows[:, TA_ALPHA].to(torch.int32)
    b = hit["b"]
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    uv_hit = (b0 * rows[:, TA_UV0] + b1 * rows[:, TA_UV1]
              + b2 * rows[:, TA_UV2])
    ones = torch.ones((b.shape[0], 3), dtype=torch.float32, device=b.device)
    alpha = bx.eval_texture_plain(scene.data, txd, uv_hit, ones)[:, 0]
    cut = hit["valid"] & (txd >= 0) & (alpha == 0.0)
    p0, p1, p2 = rows[:, TA_P0], rows[:, TA_P1], rows[:, TA_P2]
    p_hit = b0 * p0 + b1 * p1 + b2 * p2
    p_err = GAMMA7 * (torch.abs(b0 * p0) + torch.abs(b1 * p1)
                      + torch.abs(b2 * p2))
    return cut, p_hit, p_err, rows[:, TA_NG0]


def _walk_closest(scene, query, o, d, t_max):
    """Closest un-cut hit: ``query(o, t_max)``, then up to ALPHA_RETRIES
    re-spawns past zero-alpha texels, each re-walking only the cut lanes
    (the others enter with t_max 0). Returns (hit, t_base): ``valid``
    cleared where a lane is still cut, its t measured from the last
    re-spawn origin, which lies ``t_base`` along d from ``o``."""
    hit = query(o, t_max)
    cut, p_hit, p_err, ng = _alpha_cut(scene, hit)
    t_base = torch.zeros_like(t_max)
    for _ in range(ALPHA_RETRIES):
        if not _any(cut):
            break
        RETRY_COUNTS["passes"] += 1
        o = torch.where(cut[:, None], ia.spawn_ray(p_hit, p_err, ng, d), o)
        t_base = torch.where(cut, t_base + hit["t"], t_base)
        t_max = torch.where(cut, torch.clamp_min(t_max - hit["t"], 0.0),
                            t_max)
        hit = _select(cut, query(o, torch.where(cut, t_max, 0.0)), hit)
        cut, p_hit, p_err, ng = _alpha_cut(scene, hit)
    hit["valid"] = hit["valid"] & ~cut
    return hit, t_base


def _walk_occlusion(scene, query, o, d, t_max):
    """Occlusion walked past cut layers: ``query``'s closest hits (as in
    ``_walk_closest``), occluded at the first un-cut one; a layer still
    cut when the retries run out reads as opaque."""
    hit = query(o, t_max)
    cut, p_hit, p_err, ng = _alpha_cut(scene, hit)
    occluded = hit["valid"] & ~cut
    searching = cut
    for _ in range(ALPHA_RETRIES):
        if not _any(searching):
            break
        RETRY_COUNTS["passes"] += 1
        o = torch.where(searching[:, None],
                        ia.spawn_ray(p_hit, p_err, ng, d), o)
        t_max = torch.where(searching,
                            torch.clamp_min(t_max - hit["t"], 0.0), t_max)
        hit = query(o, torch.where(searching, t_max, 0.0))
        cut, p_hit, p_err, ng = _alpha_cut(scene, hit)
        occluded = occluded | (searching & hit["valid"] & ~cut)
        searching = searching & cut
    return occluded | searching


def _alpha_tree_isect(scene, o, d, t_max):
    """One closest-hit query of the alpha subset's BVH32 table (K2),
    masked triangles read as opaque, ids mapped to the scene's (a miss
    keeps id 0)."""
    RETRY_COUNTS["alpha_tree"] += 1
    h = bvhw_intersect(scene.bwa_rows, o, d, t_max, stackw=scene.bwa_depth)
    h["tri"] = torch.where(
        h["valid"], scene.bwa_map[torch.clamp_min(h["tri"], 0).long()], 0)
    return h


def _alpha_tree_closest(scene, o, d, t_max):
    """Closest un-cut hit in the alpha subset through its table. The t is
    summed over the re-spawns, approximate (~1e-4 relative); it only
    prunes the main hit, and shading recomputes p from b."""
    hit, t_base = _walk_closest(
        scene, lambda o_, t_: _alpha_tree_isect(scene, o_, d, t_), o, d,
        t_max)
    hit["t"] = torch.where(hit["valid"], t_base + hit["t"], 0.0)
    return hit


def _alpha_tree_anyhit(scene, o, d, t_max):
    """Occlusion by the alpha subset through its table."""
    return _walk_occlusion(
        scene, lambda o_, t_: _alpha_tree_isect(scene, o_, d, t_), o, d,
        t_max)


def _alpha_set_intersect(scene, o, d, t_max, any_hit=False):
    """Closest (or any) hit against the split-out alpha subset: its BVH32
    table with re-spawn retries when it has one, else the dense pass with
    the inline mask test."""
    if scene.bwa_rows is not None:
        if any_hit:
            return _alpha_tree_anyhit(scene, o, d, t_max)
        return _alpha_tree_closest(scene, o, d, t_max)
    n_op = scene.n_opaque
    sd = scene.data
    return intersect_alpha_dense(
        o, d, t_max, sd.p0[n_op:], sd.p1[n_op:], sd.p2[n_op:], n_op,
        lambda pid, b: _alpha_test_inline(scene.alpha_pack,
                                          scene.alpha_texels, pid, b),
        any_hit=any_hit)


def _closest_raw(scene, o, d, t_max):
    """One closest-hit query of the scene's route, without the retries of
    the brute-force route: the main table, then the alpha subset pruned
    by the main hit's t; or the binary tree with its inline mask test; or
    K1."""
    if scene.bw_rows is not None:
        hit = bvhw_intersect(scene.bw_rows, o, d, t_max,
                             stackw=scene.bw_depth)
        if not scene.split_alpha:
            return hit
        hit_a = _alpha_set_intersect(
            scene, o, d, torch.where(hit["valid"], hit["t"], t_max))
        # a valid alpha hit is closer than the main one (pruned by its t)
        merged = _select(hit_a["valid"], hit_a, hit)
        merged["valid"] = hit["valid"] | hit_a["valid"]
        return merged
    if scene.bvh_nodes is not None:
        return bvh_intersect(scene.bvh_nodes, scene.max_leaf,
                             scene.tri_pack, o, d, t_max,
                             alpha_pack=scene.alpha_pack,
                             alpha_texels=scene.alpha_texels)
    return intersect(o, d, t_max, scene.tri_pack)


def _scene_intersect(scene, o, d, t_max, live=None):
    """Closest hit of every lane (K2 on the BVH route, K1 otherwise);
    lanes outside ``live`` get a miss (``_lane_bounds``). On the
    brute-force route with alpha masks, cut lanes re-spawn past the
    surface up to ALPHA_RETRIES times; their t is then measured from the
    last re-spawn origin, as in the reference (no consumer reads it)."""
    with span("pt::intersect"):
        o, d = o.contiguous(), d.contiguous()
        t_max = _lane_bounds(o, t_max, live)
        if not scene.has_alpha or scene.use_bvh:
            return _closest_raw(scene, o, d, t_max)
        return _walk_closest(
            scene, lambda o_, t_: _closest_raw(scene, o_, d, t_), o, d,
            t_max)[0]


def _scene_intersect_p(scene, o, d, t_max, live=None):
    """Any hit of every lane within t_max; lanes outside ``live`` report
    none. On the split BVH route, lanes the main table already occludes
    skip the alpha pass; on the brute-force route with alpha masks,
    closest hits are walked past cut layers."""
    with span("pt::intersect"):
        o, d = o.contiguous(), d.contiguous()
        t_max = _lane_bounds(o, t_max, live)
        if scene.bw_rows is not None:
            occ = bvhw_intersect(scene.bw_rows, o, d, t_max, any_hit=True,
                                 stackw=scene.bw_depth)
            if scene.split_alpha:
                occ = occ | _alpha_set_intersect(
                    scene, o, d, torch.where(occ, 0.0, t_max), any_hit=True)
            return occ
        if scene.bvh_nodes is not None:
            return bvh_intersect(scene.bvh_nodes, scene.max_leaf,
                                 scene.tri_pack, o, d, t_max, any_hit=True,
                                 alpha_pack=scene.alpha_pack,
                                 alpha_texels=scene.alpha_texels)
        if not scene.has_alpha:
            return intersect(o, d, t_max, scene.tri_pack, any_hit=True)
        return _walk_occlusion(
            scene, lambda o_, t_: _closest_raw(scene, o_, d, t_), o, d,
            t_max)


def estimate_direct(scene, cfg, it, mp, u_scatt, u_light, light_idx,
                    wo_world, bsdf_branch=True, pick_prob=1.0, live=None,
                    env_used=None):
    """Both-strategy MIS direct lighting for one chosen light per ray.

    Returns (N, 3) radiance (pre num_lights scaling). With
    ``bsdf_branch=False`` ("onesample") only the light-sample branch runs
    and ``pick_prob`` folds into the light pdf. ``live`` ((N,) bool, None
    for all) marks the lanes whose result the caller keeps: a ray of a
    lane outside it, or of a branch whose term is zero, tests nothing.
    ``env_used`` (a list, or None: not counted) gets, at each call of the
    environment's code, the (N,) bool mask of the lanes of ``live`` whose
    environment result enters the estimate, and ``ENV_RUN`` the lanes the
    call evaluates.
    """
    sd = scene.data
    light_rows = scene.light_attr[light_idx.long()]
    ls = lt.sample_li(sd, light_rows, it["p"], it["p_error"], it["ng"],
                      u_light, light_set=scene.light_set)
    count_env = env_used is not None and LIGHT_INFINITE in scene.light_set
    if count_env:
        _build.count("env.run", light_idx.shape[0])
        took = ls["is_env"] if live is None else live
        if live is not None and len(scene.light_set) > 1:
            took = live & ls["is_env"]  # less the lanes of other lights
        env_used.append(took)
    wi = ls["wi"]
    pdf_eff = ls["pdf"] * pick_prob

    # --- light-sample branch
    f, scatt_pdf, cos_wi = bsdf_cu.bsdf_eval(mp, it, wo_world, wi,
                                             present=scene.mat_set)
    f = f * cos_wi[..., None]

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
    bs = bsdf_cu.bsdf_sample(mp, it, wo_world, u_scatt,
                             present=scene.mat_set)
    wi2_w = bs["wi"]
    f2 = bs["f"] * bs["cos"][..., None]
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
        sees_env = ls["is_env"] & ~hit2["valid"]
        li2_env = torch.where(sees_env[..., None], lt.env_le(sd, wi2_w), 0.0)
        li2 = torch.where(hit_the_light[..., None], li2, li2_env)
        if count_env:
            _build.count("env.run", light_idx.shape[0])
            sees_env = sees_env & branch2
            env_used.append(sees_env if live is None else live & sees_env)
    contrib2 = f2 * li2 * w2[..., None] / \
        torch.clamp_min(bs["pdf"], 1e-20)[..., None]
    return ld + torch.where(branch2[..., None], contrib2, 0.0)


def trace_wave(scene, cfg: PathConfig, draw, draw2, o, d, rxd=None,
               ryd=None, lane_valid=None, draw2_arr=None, occupancy=None):
    """Trace one wavefront of rays to completion.

    draw(dim) / draw2(dim) give one / two sampler dimensions for the whole
    wave; draw2_arr(dim, i, n) the i-th of n latin-hypercube 2D points
    (the stratified sampler's arrays for the all-lights strategy; None
    otherwise); rxd / ryd are the camera rays' differential directions
    (None: none), used at the first hit only. ``occupancy``, a
    (max_depth + 1,) float tensor or None, gets each bounce's live lanes
    (the bounce's own count, ``_wave_bounce``'s ``live``) added in place,
    one add a wave (the reference returns them as a fourth value); in a
    scene with an environment it holds one entry more, which gets the
    lanes of the wave's ``env_used`` masks (``_wave_bounce``), counted
    once a wave.
    Returns (L (N, 3), ray count, non-finite sample count), the two counts
    as 0-d tensors.
    """
    st = _wave_init(scene, cfg, o, d, lane_valid=lane_valid)
    live, env_used = [], []
    for bounce in range(cfg.max_depth + 1):
        with span("pt::bounce"):
            st = _wave_bounce(scene, cfg, bounce, st, draw, draw2,
                              draw2_arr=draw2_arr,
                              rxd=rxd if bounce == 0 else None,
                              ryd=ryd if bounce == 0 else None)
        live.append(st["live"])
        env_used += st.get("env_used", ())
    if occupancy is not None:
        if env_used:
            live.append(torch.cat(env_used).sum(dtype=torch.float32))
        occupancy += torch.stack(live)
    out, n_bad = _wave_radiance(cfg, st)
    return out, st["rays"], n_bad


def _bounce_stride(cfg, n_lights: int) -> int:
    """Sampler dimensions a bounce consumes: the 8 base slots, and under
    light_strategy="all" 4 more (u_light, u_scatter) a light."""
    if cfg.light_strategy == "all":
        if n_lights > MAX_ALL_LIGHTS:
            raise ValueError(f"all-lights strategy capped at "
                             f"{MAX_ALL_LIGHTS} lights, scene has "
                             f"{n_lights}")
        return DIMS_PER_BOUNCE + 4 * n_lights
    return DIMS_PER_BOUNCE


def _wave_flags(scene, cfg):
    """Static wave configuration derived from scene + cfg:
    (do_nee, one_sample, pick_prob)."""
    any_nonspec = any(m not in (MAT_MIRROR, MAT_GLASS) for m in scene.mat_set)
    do_nee = any_nonspec and scene.n_lights > 0
    one_sample = cfg.mis_mode == "onesample" and do_nee
    pick_prob = 1.0 / max(scene.n_lights, 1) \
        if cfg.light_strategy == "one" else 1.0
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


def _wave_bounce(scene, cfg, bounce, st, draw, draw2, draw2_arr=None,
                 rxd=None, ryd=None):
    """ONE wavefront bounce: intersect, Le, NEE, BSDF sample, RR.
    draw2_arr: the latin-hypercube arrays (trace_wave); rxd / ryd: the
    camera rays' differential directions (bounce 0 only). In a scene with
    an environment, ``st["env_used"]`` holds the bounce's (N,) bool masks
    of the live lanes whose environment result enters the estimate: those
    that escape (in "ref", at the camera or after a specular bounce) and
    those whose light sample, or "ref"'s BSDF sample, takes the
    environment; ``ENV_RUN`` counts the lanes each of those calls
    evaluates."""
    sd = scene.data
    do_nee, one_sample, pick_prob = _wave_flags(scene, cfg)
    last = bounce == cfg.max_depth
    dim_base = 2 + _bounce_stride(cfg, scene.n_lights) * bounce

    st = dict(st)
    o, d = st["o"], st["d"]
    n = o.shape[0]
    l, beta, active = st["l"], st["beta"], st["active"]
    specular = st["specular"]
    prev_pdf, prev_p = st["prev_pdf"], st["prev_p"]
    prev_perr, prev_ng = st["prev_perr"], st["prev_ng"]

    # the lanes that start the bounce (0-d float32, exact below 2^24)
    st["live"] = torch.sum(active.to(torch.float32))
    st["rays"] = st["rays"] + st["live"]
    # finished paths test nothing: t_max 0 on the lanes not active
    hit = _scene_intersect(scene, o, d, torch.inf, live=active)
    found = hit["valid"] & active

    with span("pt::shade"):
        # emitted radiance. "ref": camera/specular bounces only;
        # "onesample": every vertex, MIS-weighted against the previous
        # vertex's light-sampling density
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
                w_area = torch.ones((n,), dtype=torch.float32,
                                    device=o.device)
            else:
                lrows_h = scene.light_attr[torch.clamp_min(hl, 0).long()]
                lpdf = lt.pdf_li(sd, lrows_h, prev_p, prev_perr, prev_ng, d,
                                 light_set=(LIGHT_AREA,)) * pick_prob
                w_area = torch.where(specular, 1.0, pm.power_heuristic(
                    1.0, prev_pdf, 1.0, lpdf))
            l = l + torch.where((active & found)[..., None],
                                beta * le_hit * w_area[..., None], 0.0)
        else:
            l = l + torch.where((le_mask & found)[..., None], beta * le_hit,
                                0.0)
        if scene.has_env:
            # escaped rays see the environment, MIS-weighted in "onesample"
            # against the previous vertex's light-sampling density
            _build.count("env.run", n)
            seen = (active if one_sample else le_mask) & ~hit["valid"]
            le_env = lt.env_le(sd, d)
            if one_sample:
                if bounce == 0:
                    w_env = torch.ones((n,), dtype=torch.float32,
                                       device=o.device)
                else:
                    epdf = lt.env_pdf_li(sd, d) * pick_prob
                    w_env = torch.where(specular, 1.0,
                                        pm.power_heuristic(1.0, prev_pdf, 1.0,
                                                           epdf))
                l = l + torch.where(seen[..., None],
                                    beta * le_env * w_env[..., None], 0.0)
            else:
                l = l + torch.where(seen[..., None], beta * le_env, 0.0)
            st["env_used"] = [seen]
        if last:
            st["l"] = l
            return st

        mp = bx.gather_params(sd, it["material"], it["uv"], scene.mat_attr,
                              has_tex=scene.has_tex, duv=duv,
                              tex_channels=scene.tex_channels,
                              image_tex=scene.image_tex)
    cont = found
    wo = -d

    # --- NEE for materials with non-specular lobes
    rays = st["rays"]
    env_used = st.get("env_used")
    if do_nee:
        nonspec = bx.has_nonspecular(mp["mtype"]) & cont
        shadow_rays = 1.0 if one_sample else 2.0
        if cfg.light_strategy == "all":
            # one sample per light on the light's own dim slots, summed
            # (no 1/L); under the stratified sampler the n_lights points
            # form latin-hypercube arrays
            ld = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
            db0 = dim_base + DIMS_PER_BOUNCE
            for li_i in range(scene.n_lights):
                if draw2_arr is not None:
                    u_light = draw2_arr(db0, li_i, scene.n_lights)
                    u_scatt = None if one_sample else \
                        draw2_arr(db0 + 1, li_i, scene.n_lights)
                else:
                    u_light = draw2(db0 + 4 * li_i)
                    u_scatt = None if one_sample else \
                        draw2(db0 + 4 * li_i + 2)
                idx_i = torch.full((n,), li_i, dtype=torch.int32,
                                   device=o.device)
                with span("pt::nee"):
                    ld = ld + estimate_direct(scene, cfg, it, mp, u_scatt,
                                              u_light, idx_i, wo,
                                              bsdf_branch=not one_sample,
                                              live=nonspec,
                                              env_used=env_used)
            l = l + torch.where(nonspec[..., None], beta * ld, 0.0)
            rays = rays + shadow_rays * scene.n_lights * \
                torch.sum(nonspec.to(torch.float32))
        else:
            u_light = draw2(dim_base + DIM_U_LIGHT)
            u_scatt = None if one_sample else \
                draw2(dim_base + DIM_U_SCATTER)
            n_l = float(np.float32(scene.n_lights))
            if scene.n_lights > 1:
                u_pick = draw(dim_base + DIM_LIGHT_PICK)
                light_idx = torch.clamp_max((u_pick * n_l).to(torch.int32),
                                            scene.n_lights - 1)
            else:
                light_idx = torch.zeros((n,), dtype=torch.int32,
                                        device=o.device)
            with span("pt::nee"):
                ld = estimate_direct(scene, cfg, it, mp, u_scatt, u_light,
                                     light_idx, wo,
                                     bsdf_branch=not one_sample,
                                     pick_prob=pick_prob if one_sample
                                     else 1.0, live=nonspec,
                                     env_used=env_used)
            scale = 1.0 if one_sample else n_l
            l = l + torch.where(nonspec[..., None], beta * ld * scale, 0.0)
            rays = rays + shadow_rays * torch.sum(nonspec.to(torch.float32))
    st["rays"] = rays

    with span("pt::scatter"):
        # --- BSDF sampling for the next bounce
        u_bsdf = draw2(dim_base + DIM_BSDF)
        bs = bsdf_cu.bsdf_sample(mp, it, wo, u_bsdf, present=scene.mat_set)
        wi_w, cos_ns = bs["wi"], bs["cos"]
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


def _sobol_draws(su, band, frame_lo, frame_hi, frame_delta, pxf, pyf):
    """One Sobol sample frame of a band at the frame's words: (draw,
    draw2, jx, jy). On the card each draw, and the index, is one launch of
    kernel K7 (``ops/cuda/sobol_cu.py``); on the CPU the plain chain."""
    def draw(dim):
        with span("pt::sampler"):
            return sobol_cu.sobol_sample_dim(idx_lo, idx_hi, dim,
                                             band.scramble, su.sobol_pack)

    def draw2(dim):
        with span("pt::sampler"):
            return sobol_cu.sobol_sample_dim2(idx_lo, idx_hi, dim,
                                              band.scramble, su.sobol_pack)

    with span("pt::sampler"):
        idx_lo, idx_hi = sobol_cu.sobol_index(band.b_base, frame_delta,
                                              frame_lo, frame_hi, su.inv_lo,
                                              su.inv_hi)
        # camera dims 0,1 remapped into the pixel, drawn UNSCRAMBLED (as
        # the reference and PBRT's SobolSampler do)
        s01 = sobol_cu.sobol_sample_dim2(idx_lo, idx_hi, 0, None,
                                         su.sobol_pack)
        one_minus = float(pm.ONE_MINUS_EPSILON)
        jx = torch.clamp(s01[..., 0] * su.sobol_scale + su.sobol_off_x - pxf,
                         0.0, one_minus)
        jy = torch.clamp(s01[..., 1] * su.sobol_scale + su.sobol_off_y - pyf,
                         0.0, one_minus)
    return draw, draw2, jx, jy


def _hash_draws(sampler: str, pixel_hash, frame: int, total_spp_log2: int):
    """One sample frame of the stratified or random sampler: (draw,
    draw2, draw2_arr); draw2_arr is None for the random sampler."""
    if sampler == "stratified":
        def draw(dim):
            with span("pt::sampler"):
                return smp.stratified_sample_dim(pixel_hash, frame,
                                                 total_spp_log2, dim)

        def draw2(dim):
            # consecutive-dim pairs are 2D-grid stratified
            with span("pt::sampler"):
                return smp.stratified_sample_dim2(pixel_hash, frame,
                                                  total_spp_log2, dim)

        def draw2_arr(dim, i, n):
            with span("pt::sampler"):
                return smp.lhs_2d_dim(pixel_hash, frame, dim, i, n)
        return draw, draw2, draw2_arr

    def draw(dim):
        with span("pt::sampler"):
            return smp.random_sample_dim(pixel_hash, frame, dim)

    def draw2(dim):
        with span("pt::sampler"):
            return torch.stack([draw(dim), draw(dim + 1)], dim=-1)
    return draw, draw2, None


def band_frame(scene, cfg: PathConfig, su: RenderSetup, band: Band, words,
               occupancy=None):
    """One sample frame of one row band, up to its splat tile: the
    sampler's draws, the camera rays, ``trace_wave`` and ``splat_tile``.
    Returns (tile (4, Th+2h, Tw+2h), ray count, non-finite count).

    ``words`` are the frame's sampler words (``PathIntegrator.
    render_frames``): the Sobol sampler's (lo, hi, delta)
    (``ops/sobol.sobol_index``), or the stratified and random samplers'
    (frame index,); host ints, or 0-d int64 tensors on the device. The
    records' floats (the Sobol scalars, ``diff_scale``) are host floats or
    0-d float32 tensors on the device, which give the same bits.
    ``occupancy``: as ``trace_wave``'s. Every tensor it reads is a field
    of ``su`` or ``band`` or the scene's, and it copies nothing from the
    host once the constants it shares (``core/math.device_const``) exist,
    so a CUDA graph can hold it (``_BandGraph``).
    """
    th, tw = band.rows, su.ws
    pxf = band.px.to(torch.float32)
    pyf = band.py.to(torch.float32)
    draw2_arr = None
    if cfg.sampler == "sobol":
        draw, draw2, jx, jy = _sobol_draws(su, band, *words, pxf, pyf)
    else:
        draw, draw2, draw2_arr = _hash_draws(cfg.sampler, band.pixel_hash,
                                             *words, su.tsl)
        jx = draw(0)
        jy = draw(1)
    with span("pt::camera"):
        p_film = torch.stack([pxf + jx, pyf + jy], dim=-1)
        if su.dxdy_cam is not None:
            o, d, rxd, ryd = generate_rays_diff(
                su.r2c, su.cam_rot, su.cam_pos, p_film, su.dxdy_cam,
                su.diff_scale)
        else:
            o, d = generate_rays(su.r2c, su.cam_rot, su.cam_pos, p_film)
            rxd = ryd = None
    radiance, rays, n_bad = trace_wave(
        scene, cfg, draw, draw2, o, d, rxd, ryd, lane_valid=band.valid,
        draw2_arr=draw2_arr, occupancy=occupancy)
    filter_f1d, filter_radius = su.pixel_filter
    with span("pt::film"):
        tile = splat_tile(radiance.reshape(th, tw, 3), jx.reshape(th, tw),
                          jy.reshape(th, tw), band.valid.reshape(th, tw),
                          filter_f1d, radius=filter_radius)
    return tile, rays, n_bad


def _graph_engages(scene, cfg: PathConfig) -> bool:
    """Whether a band-frame of ``scene`` under ``cfg`` runs as the replay
    of a captured CUDA graph (``_BandGraph``) rather than eagerly.

    A graph holds a band-frame whose every host step is the same from
    one frame to the next and whose device work asks nothing of the host:
    on a CUDA device, a scene without alpha masks, the Sobol sampler.
    Each case left out breaks that:

    - CPU tensors: CUDA graphs exist only on a CUDA device.
    - Alpha masks (``has_alpha``: the split subset's table or dense pass,
      the all-masked binary tree's inline mask, K1's re-spawn retries):
      the retry loops end early on a host sync (``_any``,
      ``ops/intersect.intersect_alpha_dense``), which a capture refuses.
    - The stratified and random samplers: they take the frame's index as
      a host scalar (``ops/samplers.py``), which a capture would freeze.
    """
    return (scene.device.type == "cuda" and not scene.has_alpha
            and cfg.sampler == "sobol")


def _static(value, device):
    """A capture's copy of a record's field: a buffer like a tensor, a
    0-d float32 buffer for a float; an int, None or host object stays as
    it is, baked into the capture (the graph's key holds those that
    ``band_frame`` reads)."""
    if isinstance(value, torch.Tensor):
        return torch.empty_like(value)
    if isinstance(value, float):
        return torch.zeros((), dtype=torch.float32, device=device)
    return value


class _BandGraph:
    """One band-frame of one band shape, captured as CUDA graphs
    (``utils/span_graph.SpanGraph``: one graph, and, for replays under a
    profiler, a graph for each stretch of device work between two spans,
    replayed inside the same spans).

    It owns the graphs, their memory pool (the tensors the captures made,
    the outputs among them: the band-frame's tile and counts, and its live
    lanes a bounce) and the static buffers the graphs read: copies of the
    render's ``RenderSetup`` and the band's ``Band`` with a buffer in
    each tensor and float field (``_static``), and the frame's sampler
    words. ``stage`` copies a render's band into them, ``run`` a frame's
    words; the first ``run`` runs the band-frame eagerly on the capture's
    stream (the warm-up PyTorch's graph docs prescribe; its result is
    that band-frame's) and then captures it, every later one replays it.
    A replay runs the same kernels on the same bits as the eager
    ``band_frame``, and counts the hand kernels' launches that the
    capture tallied (``ops/cuda/_build.replayed``).
    """

    def __init__(self, integ: PathIntegrator, su: RenderSetup, band: Band):
        self.scene, self.cfg, self.device = su.scene, integ.cfg, su.device
        self.su, self.band = (
            dataclasses.replace(r, **{k: _static(v, self.device)
                                      for k, v in vars(r).items()})
            for r in (su, band))
        self.words = None  # 0-d int64 buffers, made at the first run
        self.graph = SpanGraph(self.device)
        self.launches = None  # a replay's hand kernel launches, once captured

    def stage(self, su: RenderSetup, band: Band) -> None:
        """Copy a render's set-up and band into the static buffers (on the
        current stream, before the frames)."""
        for static, record in ((self.su, su), (self.band, band)):
            for k, v in vars(record).items():
                buf = getattr(static, k)
                if isinstance(v, float):
                    buf.fill_(v)
                elif isinstance(buf, torch.Tensor):
                    buf.copy_(v)

    def _body(self):
        n = self.cfg.max_depth + 1 + int(self.scene.has_env)
        live = torch.zeros((n,), dtype=torch.float32, device=self.device)
        return (*band_frame(self.scene, self.cfg, self.su, self.band,
                            self.words, occupancy=live), live)

    def run(self, words) -> tuple:
        """One band-frame at the sampler words ``words``: (tile, ray
        count, non-finite count, live lanes a bounce and, in a scene with
        an environment, its used lanes: ``trace_wave``'s ``occupancy``).
        The outputs of a replay are the graph's own: read them before the
        next ``run``."""
        if self.words is None:
            self.words = tuple(torch.zeros((), dtype=torch.int64,
                                           device=self.device)
                               for _ in words)
        for buf, w in zip(self.words, words):
            buf.fill_(w)
        if self.launches is not None:
            with span("pt::graph_replay"):
                out = self.graph.replay()
            _build.replayed(self.launches)
            GRAPH_COUNTS["replays"] += 1
            return out
        with span("pt::graph_capture"):
            cur = torch.cuda.current_stream(self.device)
            self.graph.stream.wait_stream(cur)
            with torch.cuda.stream(self.graph.stream):
                out = self._body()
            for t in out:  # made on the side stream, read on this one
                t.record_stream(cur)
            tallies = []

            def body():  # each capture's launches, apart
                with _build.capturing() as tally:
                    got = self._body()
                tallies.append(tally)
                return got
            self.graph.capture(body)
            self.launches = tallies[0]
            cur.wait_stream(self.graph.stream)
        GRAPH_COUNTS["captures"] += 1
        return out


@dataclasses.dataclass(frozen=True)
class RenderSetup:
    """What every band of a render shares, on ``device``: the traced
    scene, the sample rectangle ``[x0, x1) x [y0, y1)``, the sampler's
    statics (None or 0.0 where the sampler reads none), the camera's
    parameters and the pixel filter (its (16,) host row, its radius)."""

    scene: TracedScene
    device: torch.device
    x0: int
    y0: int
    x1: int
    y1: int
    domain: object
    inv_lo: torch.Tensor | None
    inv_hi: torch.Tensor | None
    sobol_pack: torch.Tensor | None
    sobol_scale: float
    sobol_off_x: float
    sobol_off_y: float
    tsl: int  # log2 of the render's spp (the stratified sampler's)
    r2c: torch.Tensor
    cam_rot: torch.Tensor
    cam_pos: torch.Tensor
    dxdy_cam: torch.Tensor | None
    diff_scale: float
    pixel_filter: tuple

    @property
    def ws(self) -> int:
        return self.x1 - self.x0

    @property
    def hs(self) -> int:
        return self.y1 - self.y0


@dataclasses.dataclass(frozen=True)
class Band:
    """The ``rows`` rows from ``by0`` of a render (``PathIntegrator.band``)
    on the device: its lanes' int32 pixels ``px`` / ``py``, their weights
    ``valid`` (False on padding rows), the Sobol sampler's int64 words
    ``b_base`` / ``scramble`` or the hash samplers' ``pixel_hash``."""

    by0: int
    rows: int
    px: torch.Tensor
    py: torch.Tensor
    valid: torch.Tensor
    b_base: torch.Tensor | None
    scramble: torch.Tensor | None
    pixel_hash: torch.Tensor | None


class PathIntegrator:
    """Host-side render loop: builds the sample-bounds pixel grid, cuts it into
    row bands of about WAVE_LANES rays, and renders each band. It keeps
    the CUDA graphs its band-frames were captured in (``_band_graph``),
    so later renders of the same scene and band shape replay them.

    ``no_diff`` turns the camera rays' differentials off, so every texture
    lookup takes level 0: the reference's environment switch
    ``PTPU_NO_DIFF``, here an explicit argument (ROADMAP Queue 3).
    A render leaves its live lanes a bounce, summed over bands and frames,
    in ``bounce_occupancy`` (float64, max_depth + 1 entries), read at each
    chunk's sync. ``lane_bounces`` sums over every render of the
    integrator, at the same syncs, the lane-bounces run (``run``: every
    lane of every band-frame, padding lanes too, at each of its bounces,
    as the bounce loop runs them all) and those of them whose lane was
    live (``live``). ``env_lanes`` sums, in scenes with an environment,
    the lanes its code evaluates (``run``: each call site's full width,
    ``ENV_RUN``) and the live lanes whose environment result enters the
    estimate (``used``, counted on the device, ``_wave_bounce``), read at
    the same syncs."""

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
        self.bounce_occupancy = np.zeros(0, np.float64)
        self.lane_bounces = dict(live=0.0, run=0.0)
        self.env_lanes = dict(used=0.0, run=0.0)
        self._graphs: dict = {}  # _band_graph's captured band-frames
        self._traced = None  # (SceneData, its TracedScene): setup's last

    def render(self, camera: Camera, scene) -> torch.Tensor:
        """Returns the (H, W, 4) film accumulator on the scene's device."""
        return self.render_progressive(camera, scene, chunk_spp=self.spp)

    def wave_rows(self, ws: int, rows: int) -> int:
        """Rows a wave of at most WAVE_LANES lanes (or ``band_rows``)
        takes from ``rows`` rows of ``ws`` samples each."""
        return min(self.band_rows or max(1, WAVE_LANES // ws), rows)

    def band_layout(self, camera: Camera) -> tuple[int, int]:
        """(rows per band, number of bands) for this camera."""
        w, h = camera.resolution
        (x0, y0), (x1, y1) = sample_bounds(w, h, self.filter_radius)
        band = self.wave_rows(x1 - x0, y1 - y0)
        return band, -(-(y1 - y0) // band)

    def setup(self, camera: Camera, scene) -> RenderSetup:
        """The RenderSetup of a render of ``camera`` on the scene's
        device. A SceneData is traced once and its TracedScene reused
        while the same SceneData comes again, unchanged (so its band-frame
        graphs are too)."""
        if not isinstance(scene, TracedScene):
            if self._traced is None or self._traced[0] is not scene:
                self._traced = (scene, TracedScene.create(scene))
            scene = self._traced[1]
        dev = scene.device
        w, h = camera.resolution
        (x0, y0), (x1, y1) = sample_bounds(w, h, self.filter_radius)
        domain = inv_lo = inv_hi = sobol_pack = None
        scale = off_x = off_y = 0.0
        # the Sobol statics only where the Sobol sampler reads them
        if self.cfg.sampler == "sobol":
            domain = sb.SobolDomain.create((x0, y0), (x1, y1), self.spp)
            inv_lo, inv_hi = sb.vdc_inv_rows(domain, dev)
            sobol_pack = sb.sm32_device(dev)
            scale, off_x, off_y = (float(np.float32(v)) for v in (
                domain.resolution, domain.p_min[0], domain.p_min[1]))
        r2c, cam_rot, cam_pos = camera.ray_params(dev)
        diff = not self.no_diff and (scene.has_tex or scene.has_normal_maps)
        return RenderSetup(
            scene=scene, device=dev, x0=x0, y0=y0, x1=x1, y1=y1,
            domain=domain, inv_lo=inv_lo, inv_hi=inv_hi,
            sobol_pack=sobol_pack, sobol_scale=scale, sobol_off_x=off_x,
            sobol_off_y=off_y, tsl=pm.log2_int(self.spp),
            r2c=r2c, cam_rot=cam_rot, cam_pos=cam_pos,
            dxdy_cam=camera.diff_params(dev) if diff else None,
            diff_scale=float(np.float32(1.0 / np.sqrt(self.spp))),
            pixel_filter=(self.filter_f1d, self.filter_radius))

    def band(self, su: RenderSetup, by0: int, rows: int,
             y_stop: int) -> Band:
        """The Band of ``rows`` rows from ``by0``; rows from ``y_stop`` on
        are padding (zero weight)."""
        dev = su.device
        xs, ys = np.meshgrid(np.arange(su.x0, su.x1),
                             np.arange(by0, by0 + rows), indexing="xy")
        px = xs.ravel().astype(np.int32)
        py = ys.ravel().astype(np.int32)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        px_t, py_t = t(px, torch.int32), t(py, torch.int32)
        b_base = scramble = pixel_hash = None
        if su.domain is not None:
            scramble, b_base = sb.pixel_statics(
                su.domain, px, np.minimum(py, su.y1 - 1))
            b_base = t(b_base.astype(np.int64), torch.int64)
            scramble = t(scramble.astype(np.int64), torch.int64)
        else:
            with span("pt::sampler"):
                pixel_hash = smp.pixel_hash(px_t, py_t)
        return Band(by0=by0, rows=rows, px=px_t, py=py_t,
                    valid=t(py < y_stop, torch.bool), b_base=b_base,
                    scramble=scramble, pixel_hash=pixel_hash)

    def _band_graph(self, su: RenderSetup, band: Band) -> _BandGraph:
        """The captured band-frame for ``band``'s shape, made at first use.
        A graph serves every band, frame and render of its key (the scene,
        the band's shape, differentials on or off: cameras, spp and
        resolutions of that band shape only fill its buffers). Capturing
        one drops the device's others, and with them their memory pools."""
        key = (su.device, id(su.scene), self.cfg, band.rows, su.ws,
               su.dxdy_cam is not None)
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[0] != su.device}
            entry = self._graphs[key] = _BandGraph(self, su, band)
        return entry

    def render_frames(self, su: RenderSetup, film_pad, band: Band,
                      s0: int, n_frames: int, occupancy=None):
        """Render frames ``[s0, s0 + n_frames)`` of one ``band`` into the
        padded film (in place): (film_pad, ray count, non-finite count),
        each frame's live lanes a bounce added into ``occupancy`` (None:
        not counted; in a scene with an environment it holds its used
        lanes too, as ``trace_wave``'s). Each frame is a ``band_frame`` at
        its sampler words, in ``pt::band_frame``: where
        ``_graph_engages``, a replay of the band's captured graph
        (``_BandGraph``), its counts added after it as its tile is; else
        run eagerly."""
        words = [tuple(int(w) for w in sb.frame_statics(su.domain, s))
                 if su.domain is not None else (s,)
                 for s in range(s0, s0 + n_frames)]
        graph = None
        if _graph_engages(su.scene, self.cfg):
            graph = self._band_graph(su, band)
            graph.stage(su, band)
        rays_total = torch.zeros((), device=su.device)
        bad_total = torch.zeros((), device=su.device)
        half = splat_halfwidth(self.filter_radius)
        for frame_words in words:
            with span("pt::band_frame"):
                if graph is not None:
                    tile, rays, n_bad, live = graph.run(frame_words)
                    if occupancy is not None:
                        occupancy.add_(live)
                else:
                    GRAPH_COUNTS["eager"] += 1
                    tile, rays, n_bad = band_frame(
                        su.scene, self.cfg, su, band, frame_words,
                        occupancy=occupancy)
                film_pad = film_pad_accumulate(film_pad, tile, su.x0,
                                               band.by0, half=half)
                rays_total = rays_total + rays
                bad_total = bad_total + n_bad
        return film_pad, rays_total, bad_total

    def render_progressive(self, camera: Camera, scene,
                           chunk_spp: int | None = None, callback=None,
                           checkpoint: str | None = None) -> torch.Tensor:
        """Render in sample-index chunks, calling ``callback(film, done)``
        after each chunk with the (H, W, 4) film so far.

        With ``checkpoint`` (a path; ``.npz`` is appended where it lacks
        it), the padded film, the next sample frame and the spp are saved
        there after every chunk, before the callback runs (the reference
        calls it first), and a render whose film shape and spp match the
        file's resumes from it. The file is the reference's, so each
        package resumes the other's. Under the stratified and random
        samplers the chunks draw the samples of one whole render."""
        if checkpoint and not checkpoint.endswith(".npz"):
            checkpoint = checkpoint + ".npz"
        su = self.setup(camera, scene)
        dev = su.device
        self.last_ray_count = 0.0
        self.bad_sample_count = 0.0
        depths = self.cfg.max_depth + 1
        self.bounce_occupancy = np.zeros(depths, np.float64)
        # the live lanes (and the environment's used lanes) stay on the
        # device; read once a chunk
        occupancy = torch.zeros((depths + int(su.scene.has_env),),
                                dtype=torch.float64, device=dev)
        env_read = 0.0  # the used lanes read at the syncs so far
        w, h = camera.resolution
        band, n_bands = self.band_layout(camera)
        chunk = pm.round_up_pow2(min(chunk_spp or self.spp, self.spp))
        film_pad = film_pad_new(w, h, extra_rows=band, device=dev)
        s_start = 0
        if checkpoint and os.path.exists(checkpoint):
            with np.load(checkpoint) as ck:
                if ck["film_pad"].shape == tuple(film_pad.shape) and \
                        int(ck["spp"]) == self.spp:
                    film_pad = torch.as_tensor(
                        np.asarray(ck["film_pad"], np.float32), device=dev)
                    s_start = int(ck["next_frame"])

        # per-band pixel statics (host, once)
        bands = [self.band(su, su.y0 + bi * band, band, su.y1)
                 for bi in range(n_bands)]
        for s0 in range(s_start, self.spp, chunk):
            n_frames = min(chunk, self.spp - s0)
            with span("pt::chunk"):
                env_run = ENV_RUN
                stats = []  # device scalars; one sync a chunk, not a band
                for b in bands:
                    film_pad, rays, n_bad = self.render_frames(
                        su, film_pad, b, s0, n_frames, occupancy)
                    stats.append((rays, n_bad))
                with span("pt::chunk_sync"):
                    for rays, n_bad in stats:
                        self.last_ray_count += float(rays)
                        self.bad_sample_count += float(n_bad)
                    counts = occupancy.cpu().numpy().copy()  # a CPU's own
                    occ = counts[:depths]
                    self.lane_bounces["live"] += float(
                        occ.sum() - self.bounce_occupancy.sum())
                    self.lane_bounces["run"] += float(
                        n_frames * len(bands) * band * su.ws * depths)
                    self.bounce_occupancy = occ
                    if su.scene.has_env:
                        self.env_lanes["used"] += float(counts[depths]
                                                        - env_read)
                        self.env_lanes["run"] += float(ENV_RUN - env_run)
                        env_read = float(counts[depths])
                    if checkpoint:
                        np.savez(checkpoint, film_pad=film_pad.cpu().numpy(),
                                 next_frame=s0 + n_frames, spp=self.spp)
                if callback is not None:
                    with span("pt::callback"):
                        callback(film_crop(film_pad, w, h), s0 + n_frames)
        return film_crop(film_pad, w, h)
