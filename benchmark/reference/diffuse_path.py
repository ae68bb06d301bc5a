"""The reference render of the check's tiles: a path tracer in plain
PyTorch for scenes of diffuse triangles lit by triangle area lights.

``render_tiles`` renders, for sample frames ``[0, frames)`` of a job,
every camera sample whose filter footprint reaches the check's tiles,
and splats it into a film of its own. Each (pixel, frame) pair is a lane;
a wave of lanes runs its paths to the end together. What a lane does is
what pbrt-v3's path tracer does with the one-sample MIS of pbrt-v4
(``mis_mode: onesample``) and one light a vertex (``light_strategy:
one``):

- the camera: a pinhole through the raster-to-camera matrix of a
  perspective projection; the sample's position in its pixel from Sobol
  dimensions 0 and 1 (``sobol.py``);
- intersection: the watertight ray-triangle test (Woop, Benthin and Wald
  2013, as pbrt-v3 writes it) of every ray against every triangle, the
  nearest hit kept; shadow rays against every triangle too;
- the vertex: position and its error bound from the barycentrics, the
  geometric normal turned to the interpolated shading normal, the
  shading frame from dp/du of the triangle's default (0,0), (1,0), (1,1)
  parameterisation; rays leave by pbrt's robust origin offset;
- emission: every vertex's, one-sided, weighted by the power heuristic
  against the light-sampling density of the vertex before (the camera
  vertex's at full weight);
- light sampling: one light chosen uniformly, a point uniform on its
  triangle, the density converted to solid angle by re-intersecting the
  light's triangle, the power heuristic against the BSDF's density;
- the BSDF: Lambertian, cosine-weighted by Shirley's concentric map;
- Russian roulette past depth 3 with q = max(0.05, 1 - max(beta));
- the film: the Gaussian filter (alpha 2, radius 2) of pbrt's 16-entry
  table, its weight in a fourth channel.

Each bounce ``b`` draws its numbers from the Sobol dimensions ``2 + 8b``
on: the light point (+0, +1), the light's choice (+4), the BSDF
direction (+5, +6) and the roulette (+7).

The control, ``control=torch.bfloat16``, rounds the camera rays, each
bounce's state and the film's terms to that precision.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mitsuba_scene, sobol

WAVE_LANES = 1 << 17
TRI_CHUNK = 64
DIMS_PER_BOUNCE = 8
RR_START_DEPTH = 3
FILTER_RADIUS = 2.0
FILTER_ALPHA = 2.0
FILTER_TABLE = 16
SHADOW_EPSILON = 1e-4
INV_PI = float(np.float32(1.0 / np.pi))
F32_EPS = float(np.finfo(np.float32).eps) * 0.5


def gamma(n: int) -> float:
    return float(np.float32(np.float32(n * F32_EPS)
                            / (np.float32(1.0) - np.float32(n * F32_EPS))))


# --------------------------------------------------------------- vectors
def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v / torch.clamp_min(torch.sqrt(dot(v, v)), 1e-20)[..., None]


def face_forward(n, v):
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def next_up(v):
    v = torch.where(v == 0.0, torch.zeros_like(v), v)
    bits = v.view(torch.int32)
    out = torch.where(v >= 0.0, bits + 1, bits - 1).view(torch.float32)
    return torch.where(torch.isinf(v) & (v > 0), v, out)


def next_down(v):
    v = torch.where(v == 0.0, torch.full_like(v, -0.0), v)
    bits = v.view(torch.int32)
    out = torch.where(v > 0.0, bits - 1, bits + 1).view(torch.float32)
    return torch.where(torch.isinf(v) & (v < 0), v, out)


def offset_origin(p, p_err, n, w):
    """pbrt's robust ray origin: off the surface by the error bound along
    the normal, on ``w``'s side, rounded away."""
    off = dot(torch.abs(n), p_err)[..., None] * n
    off = torch.where((dot(w, n) < 0.0)[..., None], -off, off)
    po = p + off
    po = torch.where(off > 0.0, next_up(po), po)
    return torch.where(off < 0.0, next_down(po), po)


def power_heuristic(f_pdf, g_pdf):
    r = g_pdf / torch.clamp_min(f_pdf, 1e-30)
    w = 1.0 / (1.0 + r * r)
    return torch.where(f_pdf > 0.0, w, torch.zeros_like(w))


def coordinate_u(v):
    """The first vector of pbrt's ``CoordinateSystem(v)``."""
    x, y, z = v.unbind(-1)
    use_x = torch.abs(x) > torch.abs(y)
    inv = 1.0 / torch.sqrt(torch.where(use_x, x * x + z * z, y * y + z * z))
    zero = torch.zeros_like(x)
    return torch.where(use_x[..., None], torch.stack([-z, zero, x], -1),
                       torch.stack([zero, z, -y], -1)) * inv[..., None]


# ----------------------------------------------------------- intersection
def watertight(o, d, t_max, p0, p1, p2):
    """The watertight test; every argument broadcasts against the others
    (a ray's ``o``, ``d`` (..., 3), ``t_max`` (...), a triangle's corners
    (..., 3)). Returns (t, (b0, b1, b2), hit)."""
    ad = torch.abs(d)
    kz = torch.where(ad[..., 0] > ad[..., 1],
                     torch.where(ad[..., 0] > ad[..., 2], 0, 2),
                     torch.where(ad[..., 1] > ad[..., 2], 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)

    def comp(v, k):
        k = k.expand(v.shape[:-1])
        return torch.gather(v, -1, k[..., None])[..., 0]

    dx, dy, dz = comp(d, kx), comp(d, ky), comp(d, kz)
    sx, sy, sz = -dx / dz, -dy / dz, 1.0 / dz

    def shear(p):
        pt = p - o
        shape = torch.broadcast_shapes(pt.shape[:-1], kx.shape)
        pt = pt.expand(shape + (3,))
        x, y, z = comp(pt, kx), comp(pt, ky), comp(pt, kz)
        return x + sx * z, y + sy * z, z

    x0, y0, z0 = shear(p0)
    x1, y1, z1 = shear(p1)
    x2, y2, z2 = shear(p2)
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    det = e0 + e1 + e2
    z0, z1, z2 = z0 * sz, z1 * sz, z2 * sz
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    in_range = torch.where(det < 0,
                           (t_scaled < 0.0) & (t_scaled >= t_max * det),
                           (t_scaled > 0.0) & (t_scaled <= t_max * det))
    inv_det = 1.0 / torch.where(det != 0.0, det, torch.ones_like(det))
    t = t_scaled * inv_det
    max_z = torch.maximum(torch.abs(z0), torch.maximum(torch.abs(z1),
                                                       torch.abs(z2)))
    max_x = torch.maximum(torch.abs(x0), torch.maximum(torch.abs(x1),
                                                       torch.abs(x2)))
    max_y = torch.maximum(torch.abs(y0), torch.maximum(torch.abs(y1),
                                                       torch.abs(y2)))
    delta_z = gamma(3) * max_z
    delta_x = gamma(5) * (max_x + max_z)
    delta_y = gamma(5) * (max_y + max_z)
    delta_e = 2.0 * (gamma(2) * max_x * max_y + delta_y * max_x
                     + delta_x * max_y)
    max_e = torch.maximum(torch.abs(e0), torch.maximum(torch.abs(e1),
                                                       torch.abs(e2)))
    delta_t = 3.0 * (gamma(3) * max_e * max_z + delta_e * max_z
                     + delta_z * max_e) * torch.abs(inv_det)
    hit = ~(neg & pos) & (det != 0.0) & in_range & (t > delta_t)
    return t, (e0 * inv_det, e1 * inv_det, e2 * inv_det), hit


class Scene:
    """The scene's triangles and lights on the device."""

    def __init__(self, tris: dict, device):
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        p = tris["p"]
        self.p0, self.p1, self.p2 = (t(p[:, i]) for i in range(3))
        self.n0, self.n1, self.n2 = (t(tris["n"][:, i]) for i in range(3))
        self.kd = t(tris["kd"])
        self.emit = t(tris["emit"])
        self.light = t(tris["light"])
        self.light_tri = t(tris["light_tri"])
        self.n_lights = int(len(tris["light_tri"]))
        # per triangle: the unit winding normal, and dp/du of the default
        # (0,0), (1,0), (1,1) parameterisation: (p1 - p2) - (p0 - p2)
        dp02, dp12 = p[:, 0] - p[:, 2], p[:, 1] - p[:, 2]
        ng = np.cross(dp02, dp12).astype(np.float32)
        ng = ng / np.sqrt(np.maximum((ng * ng).sum(-1, keepdims=True),
                                     1e-30)).astype(np.float32)
        self.ng = t(ng.astype(np.float32))
        self.dpdu = t((dp12 - dp02).astype(np.float32))
        # the normal that emission faces: the winding normal turned to
        # the mean of the vertex normals
        ngf = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        ngf /= np.maximum(np.linalg.norm(ngf, axis=-1, keepdims=True), 1e-20)
        flip = np.einsum("fk,fk->f", ngf, tris["n"].mean(axis=1)) < 0.0
        self.ng_emit = t(np.where(flip[:, None], -ngf, ngf)
                         .astype(np.float32))

    def closest(self, o, d):
        """(hit, t, tri, b0, b1, b2) of each ray's nearest triangle."""
        n = o.shape[0]
        best_t = torch.full((n,), float("inf"), device=o.device)
        best_tri = torch.zeros((n,), dtype=torch.int64, device=o.device)
        best_b = torch.zeros((n, 3), device=o.device)
        inf = torch.full((n, 1), float("inf"), device=o.device)
        for lo in range(0, self.p0.shape[0], TRI_CHUNK):
            sl = slice(lo, lo + TRI_CHUNK)
            t, b, hit = watertight(o[:, None], d[:, None], inf,
                                   self.p0[sl], self.p1[sl], self.p2[sl])
            t = torch.where(hit, t, float("inf"))
            tc, ic = torch.min(t, dim=1)
            better = tc < best_t
            bc = torch.stack([torch.gather(x, 1, ic[:, None])[:, 0]
                              for x in b], -1)
            best_t = torch.where(better, tc, best_t)
            best_tri = torch.where(better, ic + lo, best_tri)
            best_b = torch.where(better[:, None], bc, best_b)
        return torch.isfinite(best_t), best_tri, best_b

    def occluded(self, o, d, t_max):
        out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for lo in range(0, self.p0.shape[0], TRI_CHUNK):
            sl = slice(lo, lo + TRI_CHUNK)
            _, _, hit = watertight(o[:, None], d[:, None], t_max[:, None],
                                   self.p0[sl], self.p1[sl], self.p2[sl])
            out |= hit.any(dim=1)
        return out

    def light_pdf(self, light, ref_p, ref_err, ref_n, wi):
        """Solid-angle density of sampling ``wi`` on the light's triangle
        from the reference point (0 where it misses the triangle)."""
        tri = self.light_tri[light]
        p0, p1, p2 = self.p0[tri], self.p1[tri], self.p2[tri]
        o = offset_origin(ref_p, ref_err, ref_n, wi)
        inf = torch.full(wi.shape[:-1], float("inf"), device=wi.device)
        t, _, hit = watertight(o, wi, inf, p0, p1, p2)
        hp = o + t[..., None] * wi
        n = normalize(torch.cross(p0 - p2, p1 - p2, dim=-1))
        span = torch.cross(p1 - p0, p2 - p0, dim=-1)
        area = 0.5 * torch.sqrt(dot(span, span))
        dist_sq = dot(ref_p - hp, ref_p - hp)
        pdf = dist_sq / torch.clamp_min(torch.abs(dot(n, -wi)) * area, 1e-20)
        return torch.where(hit, pdf, torch.zeros_like(pdf))

    def sample_light(self, light, u):
        """A point uniform on the light's triangle: (p, its normal, its
        error bound, the light's radiance)."""
        tri = self.light_tri[light]
        p0, p1, p2 = self.p0[tri], self.p1[tri], self.p2[tri]
        su0 = torch.sqrt(u[:, 0])
        b0 = (1.0 - su0)[:, None]
        b1 = (u[:, 1] * su0)[:, None]
        b2 = 1.0 - b0 - b1
        p = b0 * p0 + b1 * p1 + b2 * p2
        n = normalize(torch.cross(p1 - p0, p2 - p0, dim=-1))
        ns = b0 * self.n0[tri] + b1 * self.n1[tri] + b2 * self.n2[tri]
        n = face_forward(n, ns)
        err = gamma(6) * (torch.abs(b0 * p0) + torch.abs(b1 * p1)
                          + torch.abs(b2 * p2))
        return p, n, err, self.emit[tri]


# -------------------------------------------------------------- the vertex
def vertex(scene: Scene, tri, b):
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    p0, p1, p2 = scene.p0[tri], scene.p1[tri], scene.p2[tri]
    p = b0 * p0 + b1 * p1 + b2 * p2
    err = gamma(7) * (torch.abs(b0 * p0) + torch.abs(b1 * p1)
                      + torch.abs(b2 * p2))
    ns = b0 * scene.n0[tri] + b1 * scene.n1[tri] + b2 * scene.n2[tri]
    ns_len = dot(ns, ns)
    ng = scene.ng[tri]
    ns = torch.where((ns_len > 0.0)[:, None],
                     ns / torch.sqrt(torch.clamp_min(ns_len, 1e-30))[:, None],
                     ng)
    ng = face_forward(ng, ns)
    ss0 = normalize(scene.dpdu[tri])
    ts = torch.cross(ss0, ns, dim=-1)
    ts_len = dot(ts, ts)
    ts_n = ts / torch.sqrt(torch.clamp_min(ts_len, 1e-30))[:, None]
    ss = torch.where((ts_len > 0.0)[:, None],
                     torch.cross(ts_n, ns, dim=-1), coordinate_u(ns))
    return dict(p=p, err=err, ng=ng, ns=ns, ss=ss,
                ts=torch.cross(ns, ss, dim=-1), tri=tri)


def to_local(v, w):
    return torch.stack([dot(w, v["ss"]), dot(w, v["ts"]), dot(w, v["ns"])],
                       -1)


def to_world(v, w):
    return w[:, 0:1] * v["ss"] + w[:, 1:2] * v["ts"] + w[:, 2:3] * v["ns"]


def cosine_pdf(wo, wi):
    same = wo[:, 2] * wi[:, 2] > 0.0
    return torch.where(same, torch.abs(wi[:, 2]) * INV_PI,
                       torch.zeros_like(wi[:, 2]))


def cosine_direction(u):
    """Shirley's concentric map to the disk, lifted to the hemisphere."""
    uo = 2.0 * u - 1.0
    x, y = uo[:, 0], uo[:, 1]
    x_major = torch.abs(x) > torch.abs(y)
    safe_x = torch.where(x == 0.0, torch.ones_like(x), x)
    safe_y = torch.where(y == 0.0, torch.ones_like(y), y)
    r = torch.where(x_major, x, y)
    theta = torch.where(x_major, (np.pi / 4.0) * (y / safe_x),
                        (np.pi / 2.0) - (np.pi / 4.0) * (x / safe_y))
    dx, dy = r * torch.cos(theta), r * torch.sin(theta)
    centre = (x == 0.0) & (y == 0.0)
    dx = torch.where(centre, torch.zeros_like(dx), dx)
    dy = torch.where(centre, torch.zeros_like(dy), dy)
    z = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    return torch.stack([dx, dy, z], -1)


# ------------------------------------------------------------------ paths
def trace(scene: Scene, draws: sobol.Draws, o, d, max_depth: int, q):
    """Radiance of each lane's path from the camera ray (o, d)."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    big_l = torch.zeros((n, 3), dtype=f32, device=dev)
    beta = torch.ones((n, 3), dtype=f32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), dtype=f32, device=dev)
    prev_p, prev_err = o, torch.zeros_like(o)
    prev_ng = torch.zeros_like(o)
    camera_vertex = True
    pick = 1.0 / max(scene.n_lights, 1)
    for bounce in range(max_depth + 1):
        base = 2 + DIMS_PER_BOUNCE * bounce
        hit, tri, b = scene.closest(o, d)
        found = hit & active
        # emission, MIS-weighted against the light sampling of the vertex
        # before (full weight at the camera vertex)
        facing = dot(scene.ng_emit[tri], -d) > 0.0
        le = torch.where(facing[:, None], scene.emit[tri], 0.0)
        if camera_vertex:
            w_em = torch.ones((n,), dtype=f32, device=dev)
        else:
            light = torch.clamp_min(scene.light[tri], 0)
            lpdf = scene.light_pdf(light, prev_p, prev_err, prev_ng, d) \
                * pick
            w_em = power_heuristic(prev_pdf, lpdf)
        big_l = q(big_l + torch.where(found[:, None],
                                      beta * le * w_em[:, None], 0.0))
        if bounce == max_depth:
            break
        v = vertex(scene, tri, b)
        v["p"], v["err"] = q(v["p"]), q(v["err"])
        kd = scene.kd[tri]
        wo = -d
        wo_l = to_local(v, wo)

        # light sampling: one light, a point on it, a shadow ray
        u_light = draws.two(base + 0)
        if scene.n_lights > 1:
            light = torch.clamp_max(
                (draws.one(base + 4) * float(scene.n_lights)).to(torch.int64),
                scene.n_lights - 1)
        else:
            light = torch.zeros((n,), dtype=torch.int64, device=dev)
        lp, ln, lerr, lemit = scene.sample_light(light, u_light)
        wi = normalize(lp - v["p"])
        lpdf = scene.light_pdf(light, v["p"], v["err"], v["ng"], wi)
        li = torch.where((dot(ln, -wi) > 0.0)[:, None], lemit, 0.0)
        wi_l = to_local(v, wi)
        reflect = dot(wi, v["ng"]) * dot(wo, v["ng"]) > 0.0
        wo_ok = wo_l[:, 2] != 0.0
        f = torch.where((reflect & wo_ok)[:, None], kd * INV_PI, 0.0)
        f = f * torch.abs(dot(wi, v["ns"]))[:, None]
        scatter_pdf = torch.where(wo_ok, cosine_pdf(wo_l, wi_l),
                                  torch.zeros_like(lpdf))
        pdf_eff = lpdf * pick
        useful = (lpdf > 0.0) & (li != 0.0).any(-1) & (f != 0.0).any(-1)
        contrib = f * li * power_heuristic(pdf_eff, scatter_pdf)[:, None] \
            / torch.clamp_min(pdf_eff, 1e-20)[:, None]
        contrib = torch.where(useful[:, None], contrib, 0.0)
        so = offset_origin(v["p"], v["err"], v["ng"], lp - v["p"])
        target = offset_origin(lp, lerr, ln, so - lp)
        shadow_t = torch.full((n,), 1.0 - SHADOW_EPSILON, dtype=f32,
                              device=dev)
        blocked = scene.occluded(so, target - so, shadow_t)
        lit = found & useful & ~blocked
        big_l = q(big_l + torch.where(lit[:, None], beta * contrib, 0.0))

        # the next direction, by the BSDF
        wi_l = cosine_direction(draws.two(base + 5))
        wi_l = torch.where((wo_l[:, 2] < 0.0)[:, None],
                           wi_l * wi_l.new_tensor([1.0, 1.0, -1.0]), wi_l)
        pdf = cosine_pdf(wo_l, wi_l)
        f = kd * INV_PI
        wi = to_world(v, wi_l)
        dead = (f == 0.0).all(-1) | (pdf == 0.0)
        go = found & ~dead
        new_beta = beta * f * (torch.abs(dot(wi, v["ns"]))
                               / torch.clamp_min(pdf, 1e-20))[:, None]
        beta = q(torch.where(go[:, None], new_beta, beta))
        prev_pdf = torch.where(go, pdf, prev_pdf)
        prev_p = torch.where(go[:, None], v["p"], prev_p)
        prev_err = torch.where(go[:, None], v["err"], prev_err)
        prev_ng = torch.where(go[:, None], v["ng"], prev_ng)
        o = q(torch.where(go[:, None],
                          offset_origin(v["p"], v["err"], v["ng"], wi), o))
        d = q(torch.where(go[:, None], wi, d))
        camera_vertex = False

        if bounce > RR_START_DEPTH:
            m = beta.max(-1).values
            gate = go & (m < 1.0)
            q_rr = torch.clamp_min(1.0 - m, 0.05)
            kill = gate & (draws.one(base + 7) < q_rr)
            beta = q(torch.where((gate & ~kill)[:, None],
                                 beta / (1.0 - q_rr)[:, None], beta))
            go = go & ~kill
        active = go
    return torch.where(torch.isfinite(big_l), big_l, 0.0)


# ------------------------------------------------------- camera and film
def raster_to_camera(camera: dict, resolution) -> np.ndarray:
    """The inverse of the perspective projection (the camera looks down
    -z; ``fovy`` vertical, depth from ``znear`` to ``zfar``) composed with
    raster to screen; pixel (0, 0) at the top left."""
    w, h = resolution
    f = 1.0 / np.tan(float(camera["fovy"]) / 2.0)
    zn, zf = float(camera["znear"]), float(camera["zfar"])
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = f / (w / h), f
    proj[2, 2], proj[2, 3] = zf / (zn - zf), zf * zn / (zn - zf)
    proj[3, 2] = -1.0
    s2r = np.diag([w, h, 1.0, 1.0]) @ np.diag([0.5, -0.5, 1.0, 1.0]) @ \
        np.array([[1.0, 0, 0, 1], [0, 1, 0, -1], [0, 0, 1, 0], [0, 0, 0, 1]])
    return np.linalg.inv(proj) @ np.linalg.inv(s2r)


def camera_rays(camera: dict, resolution, x, y):
    """World rays through the raster points (x, y)."""
    m = raster_to_camera(camera, resolution).astype(np.float32).tolist()
    c2w = np.asarray(camera["cam_to_world"], np.float64)
    pc = [m[i][0] * x + m[i][1] * y + m[i][3] for i in range(4)]
    p = torch.stack([pc[0] / pc[3], pc[1] / pc[3], pc[2] / pc[3]], -1)
    dc = p / torch.sqrt(dot(p, p))[:, None]
    rot = c2w[:3, :3].astype(np.float32).tolist()
    d = torch.stack([dc[:, 0] * rot[i][0] + dc[:, 1] * rot[i][1]
                     + dc[:, 2] * rot[i][2] for i in range(3)], -1)
    d = d / torch.sqrt(dot(d, d))[:, None]
    o = torch.as_tensor(c2w[:3, 3].astype(np.float32),
                        device=x.device).expand_as(d)
    return o, d


def filter_row() -> np.ndarray:
    """The Gaussian's 16 table entries at (i + 0.5) r / 16."""
    d = (np.arange(FILTER_TABLE, dtype=np.float32) + 0.5) * FILTER_RADIUS \
        / FILTER_TABLE
    return np.maximum(0.0, np.exp(-FILTER_ALPHA * d * d)
                      - np.exp(-FILTER_ALPHA * FILTER_RADIUS ** 2)) \
        .astype(np.float32)


def sample_rect(w: int, h: int):
    """pbrt's sample bounds: the image grown by the filter's radius."""
    lo = int(np.floor(0.5 - FILTER_RADIUS))
    return (lo, lo), (int(np.ceil(w - 0.5 + FILTER_RADIUS)),
                      int(np.ceil(h - 0.5 + FILTER_RADIUS)))


def sample_pixels(tiles, tile_px: int, resolution):
    """The sample pixels whose footprints reach the tiles, each once."""
    half = int(np.floor(FILTER_RADIUS + 0.5))
    (x0, y0), (x1, y1) = sample_rect(*resolution)
    keys = []
    for tx, ty in tiles:
        xs = np.arange(max(tx - half, x0), min(tx + tile_px + half, x1))
        ys = np.arange(max(ty - half, y0), min(ty + tile_px + half, y1))
        gx, gy = np.meshgrid(xs, ys, indexing="xy")
        keys.append(np.stack([gy.ravel(), gx.ravel()], axis=1))
    yx = np.unique(np.concatenate(keys), axis=0)
    return yx[:, 1].astype(np.int64), yx[:, 0].astype(np.int64)


def splat(film, radiance, px, py, jx, jy, row, q):
    """Add each sample into the (H, W, 4) film, pixel (px + dx, py + dy)
    weighted by the table entries of |dx - jx + 0.5| and |dy - jy + 0.5|."""
    h, w = film.shape[:2]
    half = int(np.floor(FILTER_RADIUS + 0.5))
    flat = film.view(-1, 4)

    def weight(j, k):
        off = torch.abs(k - j + 0.5)
        i = torch.clamp_max(torch.floor(off * (1.0 / FILTER_RADIUS)
                                        * FILTER_TABLE).to(torch.int64),
                            FILTER_TABLE - 1)
        return torch.where(off <= FILTER_RADIUS, row[i], 0.0)

    for dy in range(-half, half + 1):
        wy = weight(jy, dy)
        for dx in range(-half, half + 1):
            wgt = wy * weight(jx, dx)
            x, y = px + dx, py + dy
            inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            term = torch.cat([radiance * wgt[:, None], wgt[:, None]], -1)
            term = q(torch.where(inside[:, None], term, 0.0))
            idx = torch.clamp(y, 0, h - 1) * w + torch.clamp(x, 0, w - 1)
            flat.index_put_((idx,), term, accumulate=True)


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
    scene = Scene(mitsuba_scene.load(config["scene"]["path"]), dev)
    w, h = traffic["resolution"]
    px, py = sample_pixels(tiles, traffic["check"]["tile_px"], (w, h))
    domain = sobol.Domain(*sample_rect(w, h))
    scramble = domain.scramble(px, py)
    row = torch.as_tensor(filter_row(), device=dev)
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
        splat(film, q(radiance), pxi, pyi, jx, jy, row, q)
    return q(film)
