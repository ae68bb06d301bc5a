"""Light tracing: adjoint particle transport built on the emission API.

Port of ``pathtracer_tpu/integrator_lt.py``. Paths start on the lights
(``ops/lights.sample_le``), bounce through the scene, and every vertex is
connected to the pinhole camera: visibility tested, importance-weighted,
scattered into the film. In expectation the image equals the path
tracer's of the same scene ("ref" MIS at the same ``max_depth``: the
tracer emits max_depth surface vertices and connects y0..y_D).

A light path y0, y1, ... carries flux throughput
    beta_1 = Le cos(n_l, d) / (p_light p_pos p_dir),
    beta_{k+1} = beta_k f(y_k) |cos(ns_k, w_out)| / p_scatter,
and each vertex adds to its projected pixel
    beta_k f(y_k, w_in -> w_cam) |cos(ns_k, w_cam)| V(y_k, cam) We / r^2,
We = z0^2 / (A_pix cos^3 theta_cam) turning flux at the pinhole into
pixel-mean radiance. The emission vertex y0 connects with f replaced by
the one-sided emitted radiance (area lights only: a pinhole sees delta
and infinite lights with probability zero). Specular chains toward the
camera contribute nothing; transport-mode asymmetries are not corrected,
as in the reference.

Every closest-hit and camera-visibility query goes through the path
tracer's ``_scene_intersect`` / ``_scene_intersect_p`` (K1 or K2 on the
card), lanes whose result is dropped entering with t_max 0. The reference
draws its uniforms from ``jax.random`` inside each wave; here ``_lt_wave``
takes them as arguments, and ``LightTracer`` makes them on the host from
a ``torch.Generator`` seeded by (seed, wave), so a render gives the same
film on every device up to the order of the film's atomic adds.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import math as pm
from .core.camera import Camera, project_points
from .integrator import (PathConfig, TracedScene, _scene_intersect,
                         _scene_intersect_p)
from .ops import bsdf as bx
from .ops import interaction as ia
from .ops import lights as lt
from .ops.cuda import bsdf_cu
from .scene.scene import LA_EMIT, LA_TYPE, LIGHT_AREA


def _cam_pos(cam):
    """The pinhole's world position, -R^T t of the world-to-camera
    (R, t), summed in index order."""
    _, rot, pos, _, _ = cam
    return -(rot[0] * pos[0] + rot[1] * pos[1] + rot[2] * pos[2])


def _splat(scene, cam, film, shape, p, perr, n_spawn, value, alive):
    """Connect points to the pinhole and add their contributions to the
    film, in place.

    film: the (H*W + 1, 3) flat accumulator of an (H, W) = ``shape``
    image, whose last row takes the lanes that add nothing; p / perr /
    n_spawn: (N, 3) points, their error bounds and the normal the
    visibility ray leaves along; value: (N, 3) the transported quantity
    before the camera's importance and 1/r^2; alive: (N,) bool. A lane
    adds only if alive, in front of the pinhole, inside the image
    (decided on the float raster position, so NaN and infinite ones never
    index the film), with a nonzero value and a clear segment to the
    camera."""
    c2r, w2c_rot, w2c_pos, fwd, imp = cam
    h, w = shape
    cam_pos = _cam_pos(cam)
    to_cam = cam_pos - p
    r2 = pm.norm_sq(to_cam)
    w_cam = to_cam / pm.sqrt(torch.clamp_min(r2, 1e-30))[..., None]
    raster, z_cam = project_points(c2r, w2c_rot, w2c_pos, p)
    fx = torch.floor(raster[..., 0])
    fy = torch.floor(raster[..., 1])
    in_img = (z_cam < 0.0) & (fx >= 0.0) & (fx < w) & (fy >= 0.0) & \
        (fy < h)
    live = alive & in_img & torch.any(value != 0.0, dim=-1)
    zeros = torch.zeros_like(p)
    so, sdir, st = ia.spawn_ray_to(p, perr, n_spawn, cam_pos, zeros, zeros)
    occ = _scene_intersect_p(scene, so, sdir, st, live=live)
    cos_cam = torch.clamp_min(pm.dot(w_cam, -fwd), 1e-6)
    we = imp / (cos_cam ** 3)
    contrib = value * (we / torch.clamp_min(r2, 1e-30))[..., None]
    ok = live & ~occ
    idx = torch.where(ok, fy * w + fx, float(h * w)).to(torch.int64)
    film.index_put_((idx,), torch.where(ok[..., None], contrib, 0.0),
                    accumulate=True)
    return film


def _lt_wave(scene, film, shape, cam, depth: int, u_pick, u_pos, u_dir,
             u_bounce):
    """One wave of light paths into the flat film (``_splat``).

    u_pick: (n,) uniforms of the light pick; u_pos / u_dir: (n, 2) of
    the emitted ray's position and direction; u_bounce: a (n, 2) of each
    continued bounce (depth - 1 of them). Returns the film."""
    sd = scene.data
    n_l = max(scene.n_lights, 1)
    lidx = torch.clamp_max((u_pick * n_l).to(torch.int32), n_l - 1)
    rows = scene.light_attr[lidx.long()]
    ltype = rows[:, LA_TYPE].to(torch.int32)

    s = lt.sample_le(sd, rows, u_pos, u_dir, light_set=scene.light_set)
    pdf = s["pdf_pos"] * s["pdf_dir"]
    alive = (pdf > 0.0) & torch.any(s["le"] != 0.0, dim=-1)
    cos0 = torch.abs(pm.dot(s["n_light"], s["d"]))
    beta = s["le"] * (n_l * cos0 / torch.clamp_min(pdf, 1e-30))[..., None]
    beta = torch.where(alive[..., None], beta, 0.0)
    cam_pos = _cam_pos(cam)

    # y0 -> camera: the emission vertex itself, one-sided (area only)
    if LIGHT_AREA in scene.light_set:
        area = alive & (ltype == LIGHT_AREA)
        cos_l = pm.dot(s["n_light"], pm.normalize(cam_pos - s["o"]))
        val0 = rows[:, LA_EMIT] * \
            (n_l * torch.clamp_min(cos_l, 0.0)
             / torch.clamp_min(s["pdf_pos"], 1e-30))[..., None]
        film = _splat(scene, cam, film, shape, s["o"],
                      torch.zeros_like(s["o"]), s["n_light"],
                      torch.where(area[..., None], val0, 0.0), area)

    o, d = s["o"], s["d"]
    for k in range(depth):
        hit = _scene_intersect(scene, o, d, torch.inf, live=alive)
        alive = alive & hit["valid"]
        it = ia.make_interaction(sd, o, d, hit, scene.tri_attr)
        if scene.has_normal_maps:
            it = ia.apply_normal_mapping(sd, it)
        mp = bx.gather_params(sd, it["material"], it["uv"], scene.mat_attr,
                              has_tex=scene.has_tex,
                              tex_channels=scene.tex_channels,
                              image_tex=scene.image_tex)
        wo_w = -d

        # connect y_k -> camera
        w_cam = pm.normalize(cam_pos - it["p"])
        f_cam, _, cos_cam = bsdf_cu.bsdf_eval(mp, it, wo_w, w_cam,
                                              present=scene.mat_set)
        val = beta * f_cam * cos_cam[..., None]
        film = _splat(scene, cam, film, shape, it["p"], it["p_error"],
                      it["ng"], torch.where(alive[..., None], val, 0.0),
                      alive)
        if k + 1 == depth:
            break
        # continue the light path
        bs = bsdf_cu.bsdf_sample(mp, it, wo_w, u_bounce[k],
                                 present=scene.mat_set)
        wi_w = bs["wi"]
        step = bs["f"] * (bs["cos"]
                          / torch.clamp_min(bs["pdf"], 1e-30))[..., None]
        alive = alive & (bs["pdf"] > 0.0) & torch.any(step != 0.0, dim=-1)
        beta = torch.where(alive[..., None], beta * step, 0.0)
        o = ia.spawn_ray(it["p"], it["p_error"], it["ng"], wi_w)
        d = wi_w
    return film


def wave_draws(seed: int, wave: int, n: int, depth: int):
    """The uniforms of one wave, on the host: (u_pick (n,), u_pos (n, 2),
    u_dir (n, 2), [(n, 2)] * (depth - 1)) from a CPU ``torch.Generator``
    seeded by (seed, wave)."""
    state = np.random.SeedSequence([seed, wave]).generate_state(1, np.uint64)
    g = torch.Generator().manual_seed(int(state[0]))
    u_pick = torch.rand(n, generator=g)
    u_pos = torch.rand(n, 2, generator=g)
    u_dir = torch.rand(n, 2, generator=g)
    return (u_pick, u_pos, u_dir,
            [torch.rand(n, 2, generator=g) for _ in range(depth - 1)])


class LightTracer:
    """Adjoint counterpart of PathIntegrator; the same (H, W, 4) film
    (alpha 1 everywhere). ``max_depth`` means what PathConfig.max_depth
    means: the image covers transport paths of up to max_depth + 1
    segments. ``paths`` rounds up to whole waves of ``wave`` paths."""

    def __init__(self, cfg: PathConfig = PathConfig(), paths: int = 1 << 20,
                 wave: int = 1 << 16, seed: int = 0):
        self.cfg = cfg
        self.wave = wave
        self.waves = max(1, -(-paths // wave))
        self.paths = self.waves * wave
        self.seed = seed
        self.last_ray_count = 0.0

    def render(self, camera: Camera, scene) -> torch.Tensor:
        """Returns the (H, W, 4) film on the scene's device."""
        if not isinstance(scene, TracedScene):
            scene = TracedScene.create(scene)
        dev = scene.device
        w, h = camera.resolution
        depth = self.cfg.max_depth
        cam = camera.project_params(dev)
        film = torch.zeros((h * w + 1, 3), dtype=torch.float32, device=dev)
        for i in range(self.waves):
            u_pick, u_pos, u_dir, u_bounce = wave_draws(self.seed, i,
                                                        self.wave, depth)
            film = _lt_wave(scene, film, (h, w), cam, depth, u_pick.to(dev),
                            u_pos.to(dev), u_dir.to(dev),
                            [u.to(dev) for u in u_bounce])
        # each wave traces depth segments and depth + 1 camera connections
        self.last_ray_count = float(self.paths * (2 * depth + 1))
        rgb = film[:-1].view(h, w, 3) / self.paths
        return torch.cat([rgb, torch.ones((h, w, 1), dtype=torch.float32,
                                          device=dev)], dim=-1)
