"""Packed scene representation: a dataclass of tensors + host build.

Port of ``pathtracer_tpu/scene/scene.py``: the triangle soup, material
table, light table (area, point, distant and infinite lights), constant
and checker texture descriptors and the environment map with its 2D
importance tables, as tensors. SceneBuilder accumulates all of it on the
host in numpy; reorder_triangles puts the soup in BVH leaf order. Image
textures live in the mip pool of ``scene/texture.py`` (``SceneData.tex``).
Alpha masks are built (``add_mesh``'s ``alpha_txd``); ``pack_alpha_tri``
packs the rows of the level-0 mask test that the binary traversal and the
dense alpha pass read.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.sampling import Distribution2D
from ..utils.image import bilinear_sample
from .texture import TexturePool, TexturePoolBuilder, pack_descriptors

# material type codes (same values as the JAX package)
MAT_MATTE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_METAL = 3
MAT_SUBSTRATE = 4
MAT_DISNEY = 5
MAT_ROUGHGLASS = 6

# light type codes
LIGHT_AREA = 0
LIGHT_POINT = 1
LIGHT_DISTANT = 2
LIGHT_INFINITE = 3


@dataclasses.dataclass
class SceneData:
    """Scene tensors, all on one device. Field names and meanings match
    the JAX package's SceneData; ``tex`` is the texture pool, a
    dataclass of tensors itself."""

    # triangle soup (F, ...)
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    has_normals: torch.Tensor  # (F,) bool
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    material_id: torch.Tensor  # (F,) i32
    area_light_id: torch.Tensor  # (F,) i32, -1 if not emissive
    tri_ng: torch.Tensor  # (F,3) geometric normal, face-forwarded
    tri_alpha_txd: torch.Tensor  # (F,) i32, -1 = no alpha mask

    # material table (M, ...)
    mat_type: torch.Tensor
    mat_kd: torch.Tensor
    mat_ks: torch.Tensor
    mat_eta: torch.Tensor
    mat_k: torch.Tensor
    mat_rough: torch.Tensor
    mat_misc: torch.Tensor
    mat_remap: torch.Tensor

    # light table (L, ...)
    light_type: torch.Tensor
    light_emit: torch.Tensor
    light_tri: torch.Tensor
    light_vec: torch.Tensor

    # texture descriptors (K, ...): kind 0 = constant, 1 = checker,
    # 2 = image (txd_image: its id in the pool ``tex``)
    txd_kind: torch.Tensor
    txd_rgb0: torch.Tensor
    txd_rgb1: torch.Tensor
    txd_scale: torch.Tensor
    txd_uv: torch.Tensor
    txd_image: torch.Tensor
    txd_channel: torch.Tensor
    txd_srgb: torch.Tensor
    tex: TexturePool

    # per-material texture bindings (-1 = constant table value)
    mat_kd_tx: torch.Tensor
    mat_ks_tx: torch.Tensor
    mat_metallic_tx: torch.Tensor
    mat_rough_tx: torch.Tensor
    mat_normal_tx: torch.Tensor

    # environment light (1x1 black placeholders when absent)
    env_map: torch.Tensor
    env_cond_func: torch.Tensor
    env_cond_cdf: torch.Tensor
    env_cond_int: torch.Tensor
    env_marg_func: torch.Tensor
    env_marg_cdf: torch.Tensor
    env_marg_int: torch.Tensor
    env_to_world: torch.Tensor
    world_to_env: torch.Tensor

    # scalars (0-d tensors)
    world_center: torch.Tensor
    world_radius: torch.Tensor
    n_lights: torch.Tensor
    has_env: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.p0.device

    @functools.cached_property
    def txd_rows(self) -> tuple:
        """The texture kernels' packed descriptor tables (f32, i32) on the
        pool's device (texture.pack_descriptors), built at first use
        (``TracedScene.from_tables`` asks at set-up) and kept on this
        SceneData; not a leaf: ``to`` and ``dataclasses.replace`` build
        them anew."""
        return pack_descriptors(self.txd_kind, self.txd_uv, self.txd_rgb0,
                                self.txd_rgb1, self.txd_scale,
                                self.txd_image, self.txd_channel,
                                self.txd_srgb, self.tex)

    def to(self, device) -> "SceneData":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def _np(x) -> np.ndarray:
    """Host numpy view of a tensor (or array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _f32(x) -> np.ndarray:
    return _np(x).astype(np.float32)


# Packed per-row attribute matrices: the hot path fetches ONE packed row
# per index instead of a dozen separate gathers. Integer ids ride as exact
# f32. Column layouts match the JAX package.

# tri_attr columns
TA_P0 = slice(0, 3)
TA_P1 = slice(3, 6)
TA_P2 = slice(6, 9)
TA_N0 = slice(9, 12)
TA_N1 = slice(12, 15)
TA_N2 = slice(15, 18)
TA_UV0 = slice(18, 20)
TA_UV1 = slice(20, 22)
TA_UV2 = slice(22, 24)
TA_NG0 = slice(24, 27)   # unflipped unit geometric normal cross(p0-p2, p1-p2)
TA_NGF = slice(27, 30)   # face-forwarded tri_ng (emission lookups)
TA_DPDU = slice(30, 33)  # per-tri dpdu with degenerate fallback applied
TA_DPDV = slice(33, 36)
TA_KE = slice(36, 39)    # per-tri emission (area lights; zeros otherwise)
TA_MAT = 39
TA_LID = 40
TA_HASN = 41
TA_ALPHA = 42
TA_WIDTH = 43

# light_attr columns
LA_TYPE = 0
LA_EMIT = slice(1, 4)
LA_VEC = slice(4, 7)
LA_P0 = slice(7, 10)
LA_P1 = slice(10, 13)
LA_P2 = slice(13, 16)
LA_N0 = slice(16, 19)
LA_N1 = slice(19, 22)
LA_N2 = slice(22, 25)
LA_HASN = 25
LA_WIDTH = 26

# mat_attr columns
MA_TYPE = 0
MA_KD = slice(1, 4)
MA_KS = slice(4, 7)
MA_ETA = slice(7, 10)
MA_K = slice(10, 13)
MA_ROUGH = slice(13, 15)
MA_MISC = slice(15, 19)
MA_REMAP = 19
MA_WIDTH = 20


# alpha_pack columns (F, 16): the level-0 mask test of a masked triangle
# (accel/bvh._alpha_test_inline). The pool offset of level 0 rides as the
# BIT PATTERN of an int32, not as a float value, so pools above 2^24
# texels stay exact.
AP_UV0 = slice(0, 2)
AP_UV1 = slice(2, 4)
AP_UV2 = slice(4, 6)
AP_SUSV = slice(6, 8)    # UVMap scale (su, sv)
AP_OUOV = slice(8, 10)   # UVMap offset (ou, ov)
AP_BASE = 10             # level-0 pool offset (int32 bits)
AP_W = 11                # level-0 width (exact f32)
AP_H = 12                # level-0 height
AP_WRAP = 13             # wrap mode
AP_FLAG = 14             # 1.0 if the triangle carries an alpha mask
AP_WIDTH = 16


def pack_alpha_tri(sd: SceneData):
    """(F, AP_WIDTH) mask-test rows and the (total,) level-0 texel column
    ``pool.data[:, 0]``, host numpy; (None, None) when no triangle
    carries a mask. Mask textures are plain image descriptors (scale 1,
    no sRGB, alpha replicated to RGB by the importer), so the test is a
    level-0 bilinear of pool column 0 at the UV-mapped st."""
    alpha = _np(sd.tri_alpha_txd)
    if not (alpha >= 0).any():
        return None, None
    txd = np.maximum(alpha, 0)
    uvm = _f32(sd.txd_uv)[txd]  # (F, 4) su sv ou ov
    tex = _np(sd.txd_image)[txd]
    pool = sd.tex
    base = _np(pool.level_offset)[tex, 0].astype(np.int32)
    rows = np.zeros((alpha.shape[0], AP_WIDTH), np.float32)
    rows[:, AP_UV0] = _f32(sd.uv0)
    rows[:, AP_UV1] = _f32(sd.uv1)
    rows[:, AP_UV2] = _f32(sd.uv2)
    rows[:, AP_SUSV] = uvm[:, 0:2]
    rows[:, AP_OUOV] = uvm[:, 2:4]
    rows[:, AP_BASE] = base.view(np.float32)
    rows[:, AP_W] = _np(pool.level_w)[tex, 0].astype(np.float32)
    rows[:, AP_H] = _np(pool.level_h)[tex, 0].astype(np.float32)
    rows[:, AP_WRAP] = _np(pool.wrap)[tex].astype(np.float32)
    rows[:, AP_FLAG] = (alpha >= 0).astype(np.float32)
    return rows, np.ascontiguousarray(_f32(pool.data)[:, 0])


def pack_tri_attr(sd: SceneData) -> np.ndarray:
    """(F, TA_WIDTH) packed per-triangle shading attributes (host numpy):
    dpdu/dpdv from the UV parameterization with the degenerate fallback
    frame, the unit geometric normal and the per-triangle emission."""
    p0, p1, p2 = _f32(sd.p0), _f32(sd.p1), _f32(sd.p2)
    uv0, uv1, uv2 = _f32(sd.uv0), _f32(sd.uv1), _f32(sd.uv2)
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degenerate = np.abs(det) < 1e-8
    inv_det = 1.0 / np.where(degenerate, 1.0, det)
    dpdu = ((duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12)
            * inv_det[:, None]).astype(np.float32)
    dpdv = ((-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12)
            * inv_det[:, None]).astype(np.float32)
    ng_raw = np.cross(dp02, dp12).astype(np.float32)
    ng0 = (ng_raw / np.sqrt(np.maximum(
        (ng_raw * ng_raw).sum(-1, keepdims=True), 1e-30))).astype(np.float32)
    bad = degenerate | ((np.cross(dpdu, dpdv) ** 2).sum(-1) == 0.0)
    use_x = np.abs(ng0[:, 0]) > np.abs(ng0[:, 1])
    cx = np.where(use_x, 1.0 / np.sqrt(np.maximum(
        ng0[:, 0] ** 2 + ng0[:, 2] ** 2, 1e-30)), 0.0).astype(np.float32)
    cy = np.where(use_x, 0.0, 1.0 / np.sqrt(np.maximum(
        ng0[:, 1] ** 2 + ng0[:, 2] ** 2, 1e-30))).astype(np.float32)
    fb_u = np.where(use_x[:, None],
                    np.stack([-ng0[:, 2] * cx, np.zeros_like(cx),
                              ng0[:, 0] * cx], -1),
                    np.stack([np.zeros_like(cy), ng0[:, 2] * cy,
                              -ng0[:, 1] * cy], -1)).astype(np.float32)
    fb_v = np.cross(ng0, fb_u).astype(np.float32)
    dpdu = np.where(bad[:, None], fb_u, dpdu)
    dpdv = np.where(bad[:, None], fb_v, dpdv)

    lid = _np(sd.area_light_id).astype(np.int32)
    emit = _f32(sd.light_emit)
    ke = np.where((lid >= 0)[:, None], emit[np.maximum(lid, 0)], 0.0)

    cols = np.concatenate([
        p0, p1, p2, _f32(sd.n0), _f32(sd.n1), _f32(sd.n2), uv0, uv1, uv2,
        ng0, _f32(sd.tri_ng), dpdu, dpdv, ke,
        _f32(sd.material_id)[:, None], lid.astype(np.float32)[:, None],
        _f32(sd.has_normals)[:, None], _f32(sd.tri_alpha_txd)[:, None],
    ], axis=1).astype(np.float32)
    assert cols.shape[1] == TA_WIDTH
    return cols


def pack_light_attr(sd: SceneData) -> np.ndarray:
    """(L, LA_WIDTH) packed light table incl. the area light's triangle."""
    ltri = np.maximum(_np(sd.light_tri).astype(np.int32), 0)
    cols = np.concatenate([
        _f32(sd.light_type)[:, None], _f32(sd.light_emit),
        _f32(sd.light_vec),
        _f32(sd.p0)[ltri], _f32(sd.p1)[ltri], _f32(sd.p2)[ltri],
        _f32(sd.n0)[ltri], _f32(sd.n1)[ltri], _f32(sd.n2)[ltri],
        _f32(sd.has_normals)[ltri][:, None],
    ], axis=1).astype(np.float32)
    assert cols.shape[1] == LA_WIDTH
    return cols


def pack_mat_attr(sd: SceneData) -> np.ndarray:
    """(M, MA_WIDTH) packed material constant table."""
    cols = np.concatenate([
        _f32(sd.mat_type)[:, None], _f32(sd.mat_kd), _f32(sd.mat_ks),
        _f32(sd.mat_eta), _f32(sd.mat_k), _f32(sd.mat_rough),
        _f32(sd.mat_misc), _f32(sd.mat_remap)[:, None],
    ], axis=1).astype(np.float32)
    assert cols.shape[1] == MA_WIDTH
    return cols


_TRIANGLE_FIELDS = ("p0", "p1", "p2", "n0", "n1", "n2", "has_normals",
                    "uv0", "uv1", "uv2", "material_id", "area_light_id",
                    "tri_ng", "tri_alpha_txd")


def reorder_triangles(scene: SceneData, order) -> SceneData:
    """Permute the triangle soup (e.g. into BVH leaf order).

    ``order[k]`` is the old index of the triangle now at slot k. Area-light
    triangle references are remapped through the inverse permutation.
    """
    order = np.asarray(order, np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    lt = _np(scene.light_tri)
    light_tri = np.where(lt >= 0, inv[np.maximum(lt, 0)],
                         lt).astype(np.int32)
    idx = torch.as_tensor(order, device=scene.device)
    return dataclasses.replace(
        scene, light_tri=torch.as_tensor(light_tri, device=scene.device),
        **{name: getattr(scene, name)[idx] for name in _TRIANGLE_FIELDS})


_DEFAULT_MATERIAL = dict(
    mtype=MAT_MATTE, kd=(0.5, 0.5, 0.5), ks=(0.0, 0.0, 0.0),
    eta=(1.5, 1.5, 1.5), k=(0.0, 0.0, 0.0), rough=(0.0, 0.0),
    misc=(0.0, 0.0, 0.0, 0.0), remap=False,
    kd_tx=-1, ks_tx=-1, metallic_tx=-1, rough_tx=-1, normal_tx=-1)

_NO_TEXTURE = dict(kind=0, rgb0=(0, 0, 0), rgb1=(0, 0, 0), scale=(1, 1, 1),
                   uv=(1, 1, 0, 0), image=0, channel=-1, srgb=False)

# luminance weights of the environment's importance image
_LUM_RGB = np.asarray([0.212671, 0.715160, 0.072169], np.float32)


def _env_tables(image: np.ndarray, l2w: np.ndarray) -> dict:
    """The environment light's SceneData fields: the equirect map, the 2D
    distribution of its sin(theta)-weighted luminance sampled bilinearly
    on a grid of twice its resolution, and the light's rotation."""
    he, we = image.shape[:2]
    h2, w2 = 2 * he, 2 * we
    vs = (np.arange(h2) + 0.5) / h2
    us = (np.arange(w2) + 0.5) / w2
    sin_theta = np.sin(np.pi * vs)
    lum = np.asarray(image, np.float32) @ _LUM_RGB
    func = (bilinear_sample(lum, us, vs) * sin_theta[:, None]) \
        .astype(np.float32)
    tables = {"env_" + k: v
              for k, v in Distribution2D.build_host(func).items()}
    l2w = np.asarray(l2w, np.float32)[:3, :3]
    return dict(env_map=np.asarray(image, np.float32), **tables,
                env_to_world=l2w,
                world_to_env=np.linalg.inv(l2w).astype(np.float32))


class SceneBuilder:
    """Host-side accumulation of meshes, materials, texture descriptors,
    lights and the environment -> SceneData."""

    def __init__(self) -> None:
        self.tex_pool = TexturePoolBuilder()
        self.txds: list[dict] = []
        self.tri_p: list[np.ndarray] = []  # (f,3,3) per mesh
        self.tri_n: list[np.ndarray] = []
        self.tri_has_n: list[np.ndarray] = []
        self.tri_uv: list[np.ndarray] = []
        self.tri_mat: list[np.ndarray] = []
        self.tri_light: list[np.ndarray] = []
        self.tri_alpha: list[np.ndarray] = []
        self.n_tri = 0  # the triangles added so far
        self.materials: list[dict] = []
        self.lights: list[dict] = []
        self.env: dict | None = None

    def add_material(self, **kwargs) -> int:
        mat = dict(_DEFAULT_MATERIAL)
        mat.update(kwargs)
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_texture_checker(self, color0, color1, uv=(1, 1, 0, 0)) -> int:
        """Checker texture descriptor over the UV map (su, sv, ou, ov)."""
        self.txds.append(dict(_NO_TEXTURE, kind=1, rgb0=color0, rgb1=color1,
                              uv=uv))
        return len(self.txds) - 1

    def add_texture_image(self, image, scale=(1, 1, 1), uv=(1, 1, 0, 0),
                          wrap: int = 0, channel: int = -1,
                          srgb: bool = False) -> int:
        """Image texture descriptor over the UV map, backed by the mip
        pool: ``scale`` multiplies the texels, ``channel`` >= 0 broadcasts
        one of them, ``srgb`` decodes them to linear."""
        tex_id = self.tex_pool.add(image, wrap)
        self.txds.append(dict(_NO_TEXTURE, kind=2, scale=scale, uv=uv,
                              image=tex_id, channel=channel, srgb=srgb))
        return len(self.txds) - 1

    def add_mesh(self, positions: np.ndarray, indices: np.ndarray,
                 normals: np.ndarray | None, uvs: np.ndarray | None,
                 material_id: int, emission: np.ndarray | None = None,
                 alpha_txd: int = -1) -> None:
        """Add a world-space triangle mesh: positions (V,3), indices (F,3),
        normals (V,3) or None, uvs (V,2) or None. With ``emission`` set,
        every triangle becomes one diffuse area light. ``alpha_txd`` is
        the descriptor of the mesh's alpha cutout mask (-1: none)."""
        positions = np.asarray(positions, np.float32)
        indices = np.asarray(indices, np.int64)
        f = indices.shape[0]
        first_tri = self.n_tri
        self.n_tri += f
        p = positions[indices]  # (F,3,3)
        self.tri_p.append(p)
        if normals is not None and len(normals):
            self.tri_n.append(np.asarray(normals, np.float32)[indices])
            self.tri_has_n.append(np.ones(f, bool))
        else:
            self.tri_n.append(np.zeros_like(p))
            self.tri_has_n.append(np.zeros(f, bool))
        if uvs is not None and len(uvs):
            self.tri_uv.append(np.asarray(uvs, np.float32)[indices])
        else:
            default_uv = np.array([[0, 0], [1, 0], [1, 1]], np.float32)
            self.tri_uv.append(np.broadcast_to(default_uv, (f, 3, 2)).copy())
        self.tri_mat.append(np.full(f, material_id, np.int32))
        self.tri_alpha.append(np.full(f, alpha_txd, np.int32))
        if emission is not None:
            light_ids = []
            for i in range(f):
                self.lights.append(dict(
                    ltype=LIGHT_AREA, emit=np.asarray(emission, np.float32),
                    tri=first_tri + i, vec=np.zeros(3, np.float32)))
                light_ids.append(len(self.lights) - 1)
            self.tri_light.append(np.asarray(light_ids, np.int32))
        else:
            self.tri_light.append(np.full(f, -1, np.int32))

    def add_point_light(self, position, intensity) -> None:
        self.lights.append(dict(
            ltype=LIGHT_POINT, emit=np.asarray(intensity, np.float32),
            tri=-1, vec=np.asarray(position, np.float32)))

    def add_distant_light(self, direction, radiance) -> None:
        """``direction`` points toward the light."""
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        self.lights.append(dict(
            ltype=LIGHT_DISTANT, emit=np.asarray(radiance, np.float32),
            tri=-1, vec=d))

    def set_environment(self, image: np.ndarray, light_to_world: np.ndarray,
                        scale: np.ndarray | float = 1.0) -> None:
        """Equirect HDR environment light (H, W, 3), rotated into the world
        by ``light_to_world``."""
        img = np.asarray(image, np.float32) * np.asarray(scale, np.float32)
        self.env = dict(image=img,
                        l2w=np.asarray(light_to_world, np.float32))
        self.lights.append(dict(
            ltype=LIGHT_INFINITE, emit=np.ones(3, np.float32),
            tri=-1, vec=np.zeros(3, np.float32)))

    def build(self, device="cuda") -> SceneData:
        if not self.tri_p:
            raise ValueError("scene has no geometry")
        p = np.concatenate(self.tri_p)  # (F,3,3)
        n = np.concatenate(self.tri_n)
        has_n = np.concatenate(self.tri_has_n)
        uv = np.concatenate(self.tri_uv)
        mat = np.concatenate(self.tri_mat)
        lid = np.concatenate(self.tri_light)

        # per-triangle geometric normal, face-forwarded toward the vertex
        # normals (lets emission lookups skip the full interaction build)
        ng = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
        flip = has_n & (np.einsum("fk,fk->f", ng, n.mean(axis=1)) < 0.0)
        ng = np.where(flip[:, None], -ng, ng).astype(np.float32)

        lo = p.reshape(-1, 3).min(0)
        hi = p.reshape(-1, 3).max(0)
        center = (lo + hi) / 2
        radius = float(np.linalg.norm(hi - center))

        mats = self.materials or [dict(_DEFAULT_MATERIAL)]
        txds = self.txds or [_NO_TEXTURE]
        lights = self.lights or [dict(ltype=LIGHT_POINT,
                                      emit=np.zeros(3, np.float32), tri=-1,
                                      vec=np.zeros(3, np.float32))]

        def f32(x):
            return np.asarray(x, np.float32)

        def i32(x):
            return np.asarray(x, np.int32)

        fields = dict(
            p0=f32(p[:, 0]), p1=f32(p[:, 1]), p2=f32(p[:, 2]),
            n0=f32(n[:, 0]), n1=f32(n[:, 1]), n2=f32(n[:, 2]),
            has_normals=np.asarray(has_n),
            uv0=f32(uv[:, 0]), uv1=f32(uv[:, 1]), uv2=f32(uv[:, 2]),
            material_id=i32(mat), area_light_id=i32(lid), tri_ng=f32(ng),
            tri_alpha_txd=np.concatenate(self.tri_alpha),
            mat_type=i32([m["mtype"] for m in mats]),
            mat_kd=f32([m["kd"] for m in mats]),
            mat_ks=f32([m["ks"] for m in mats]),
            mat_eta=f32([m["eta"] for m in mats]),
            mat_k=f32([m["k"] for m in mats]),
            mat_rough=f32([m["rough"] for m in mats]),
            mat_misc=f32([m["misc"] for m in mats]),
            mat_remap=np.asarray([bool(m["remap"]) for m in mats]),
            mat_kd_tx=i32([m["kd_tx"] for m in mats]),
            mat_ks_tx=i32([m["ks_tx"] for m in mats]),
            mat_metallic_tx=i32([m["metallic_tx"] for m in mats]),
            mat_rough_tx=i32([m["rough_tx"] for m in mats]),
            mat_normal_tx=i32([m["normal_tx"] for m in mats]),
            txd_kind=i32([t["kind"] for t in txds]),
            txd_rgb0=f32([t["rgb0"] for t in txds]),
            txd_rgb1=f32([t["rgb1"] for t in txds]),
            txd_scale=f32([t["scale"] for t in txds]),
            txd_uv=f32([t["uv"] for t in txds]),
            txd_image=i32([t["image"] for t in txds]),
            txd_channel=i32([t["channel"] for t in txds]),
            txd_srgb=np.asarray([bool(t["srgb"]) for t in txds]),
            light_type=i32([li["ltype"] for li in lights]),
            light_emit=f32([li["emit"] for li in lights]),
            light_tri=i32([li["tri"] for li in lights]),
            light_vec=f32([li["vec"] for li in lights]),
            world_center=f32(center), world_radius=np.float32(radius),
            n_lights=np.int32(len(self.lights)),
            has_env=np.asarray(self.env is not None),
        )
        if self.env is not None:
            fields.update(_env_tables(self.env["image"], self.env["l2w"]))
        else:  # 1x1 black placeholders
            fields.update(
                env_map=f32(np.zeros((1, 1, 3))),
                env_cond_func=f32(np.zeros((1, 1))),
                env_cond_cdf=f32(np.zeros((1, 2))),
                env_cond_int=f32(np.zeros(1)),
                env_marg_func=f32(np.zeros(1)),
                env_marg_cdf=f32(np.zeros(2)),
                env_marg_int=np.float32(0.0),
                env_to_world=f32(np.eye(3)), world_to_env=f32(np.eye(3)))
        return SceneData(tex=self.tex_pool.build(device), **{
            k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in fields.items()})
