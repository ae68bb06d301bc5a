"""The reference render of the check's tiles for glTF scenes of instanced
Disney triangles lit by point lights (``flake_scene.py``: the
sphereflake), in plain PyTorch, float32.

``render_tiles`` renders, as ``sphere_path.render_tiles`` does, every
camera sample of sample frames ``[0, frames)`` whose filter footprint
reaches the check's tiles, a lane a (pixel, frame) pair, and splats it
into a film of its own. The camera rays, the vertex and its frame, the
Trowbridge-Reitz functions, the roulette and the film are
``sphere_path``'s, the watertight test ``diffuse_path``'s. What is new:

**Intersection in two levels.** A brute force over 1.3 M triangles would
not finish, so each mesh node's instance gets a bounding sphere: the
centre of its vertices' box, the radius its farthest vertex's distance,
padded by 1 % and 1e-5. A ray's segment ([0, t_max] of o + t d) is tested
against every instance's sphere; the instances it meets are taken in the
order of the segment's entry, and each one's triangles all go through the
watertight test, until the entry lies beyond the nearest hit so far (for
a shadow ray, until a hit). A hit of the watertight test lies in its
triangle's instance's sphere, so the nearest hit is the brute force's; of
equal distances within an instance the first triangle's wins, across
instances the instance entered first.

**Point lights**, one chosen uniformly at each vertex: the direction to
the light's position from the vertex, the radiance its intensity over the
squared distance, the density 1 (a delta light: the light's sample is
weighted 1, no BSDF sample is weighed against it); the shadow ray from
pbrt's offset origin to the light's position, to 1 - 1e-4 of it.

**The Disney BSDF** (the JAX package's and pathtracer-rs's: Burley
diffuse and Trowbridge-Reitz reflection, no sheen, clearcoat or
transmission), of base colour c, metallic m, the Trowbridge-Reitz alpha
max(0.001, roughness^2) and eta:

- diffuse: (1 - m) c / pi (1 - F(|cos wo|) / 2) (1 - F(|cos wi|) / 2),
  F(x) = clamp(1 - x, 0, 1)^5;
- specular: D(wh) G1(wo) G1(wi) Fr / (4 |cos wi| |cos wo|) (zero where wh
  or either cosine is 0), Smith's G separable; Fr = lerp(the dielectric
  Fresnel term of eta at wi . wh, Schlick's with r0 = lerp(((eta - 1) /
  (eta + 1))^2, c, m), m);
- f zero unless the geometric normal sees wo and wi on one side; the
  density 0.5 (cosine density + the visible normal's reflection density);
- the sample: u0 < 1/2 takes the cosine lobe, else the visible normal's
  reflection, u0 stretched back over its half as 2 u0 - floor(2 u0)
  (floor at most 1); the density and f of both lobes at the direction
  taken, zero for a reflection whose half vector faces away from wo.

At each vertex: light sampling (no surface here is specular), the next
direction by the BSDF, Russian roulette past depth 3 on max(beta). Nothing
emits: no triangle is an emitter and there is no environment. Each bounce
``b`` draws from Sobol dimensions ``2 + 8b`` on: the light's choice (+4),
the BSDF (+5, +6), the roulette (+7).

The control, ``control=torch.bfloat16``, rounds the camera rays, each
bounce's state and the film's terms to that precision.
"""

from __future__ import annotations

import numpy as np
import torch

from . import diffuse_path as dp
from . import flake_scene, sobol
from . import sphere_path as sp

WAVE_LANES = 1 << 17
DIMS_PER_BOUNCE = 8
RR_START_DEPTH = 3
INV_PI = dp.INV_PI
PAD_REL, PAD_ABS = 0.01, 1e-5
# ray x instance sphere tests, and ray x triangle tests, a step
PAIR_BUDGET = 1 << 22
TEST_BUDGET = 1 << 21


# ----------------------------------------------------------------- Disney
def schlick_weight(c):
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    return (m * m) * (m * m) * m


def lerp(x, y, a):
    return x * (1.0 - a) + y * a


def lobes(m):
    """(the diffuse colour (1 - metallic) c, Schlick's r0 colour)."""
    c, metallic, eta = m["kd"], m["metallic"], m["eta"]
    r0 = ((eta - 1.0) * (eta - 1.0) / ((eta + 1.0) * (eta + 1.0)))[:, None]
    return (1.0 - metallic)[:, None] * c, \
        lerp(r0 * torch.ones_like(c), c, metallic[:, None])


def fresnel(m, c_spec0, cos_i):
    diel = sp.fr_dielectric(cos_i, m["eta"])[:, None]
    schlick = lerp(c_spec0, torch.ones_like(c_spec0),
                   schlick_weight(cos_i)[:, None])
    return lerp(diel.expand(schlick.shape), schlick, m["metallic"][:, None])


def disney_f(m, wo, wi):
    """f of both lobes at local (wo, wi), before the geometric-normal
    test."""
    dif_c, c_spec0 = lobes(m)
    a = m["alpha"]
    cto, cti = torch.abs(wo[:, 2]), torch.abs(wi[:, 2])
    diffuse = dif_c * INV_PI * ((1.0 - schlick_weight(cto) / 2.0)
                                * (1.0 - schlick_weight(cti) / 2.0))[:, None]
    wh = wi + wo
    whn = sp.normalize(wh)
    fr = fresnel(m, c_spec0, sp.dot(wi, whn))
    g = sp.tr_g1(wo, a) * sp.tr_g1(wi, a)
    spec = torch.ones_like(dif_c) * sp.tr_d(whn, a)[:, None] * g[:, None] \
        * fr / torch.clamp_min(4.0 * cti * cto, 1e-20)[:, None]
    ok = (sp.dot(wh, wh) > 0.0) & (cti > 0.0) & (cto > 0.0)
    return diffuse + torch.where(ok[:, None], spec, 0.0)


def disney_pdf(wo, wi, a):
    return 0.5 * (sp.cosine_pdf(wo, wi) + sp.metal_pdf(wo, wi, a))


def eval_f_pdf(m, wo, wi, reflect_ng):
    wo_ok = wo[:, 2] != 0.0
    f = disney_f(m, wo, wi)
    return (torch.where((reflect_ng & wo_ok)[:, None], f, 0.0),
            torch.where(wo_ok, disney_pdf(wo, wi, m["alpha"]), 0.0))


def sample_f(m, wo, u, reflect_ng_fn):
    """dict(wi, f, pdf) of the BSDF's sample at local wo and u (N, 2)."""
    a = m["alpha"]
    u0 = u[:, 0]
    comp = torch.clamp_max(torch.floor(u0 * 2.0), 1.0)
    ud = torch.stack([u0 * 2.0 - comp, u[:, 1]], -1)
    take_diff = comp == 0.0
    wi_cos = sp.flip_to(sp.cosine_direction(ud), wo)
    wh = sp.tr_sample_wh(wo, ud, a)
    wi_spec = sp.reflect(wo, wh)
    spec_ok = (wo[:, 2] != 0.0) & (sp.dot(wo, wh) >= 0.0)
    wi = torch.where(take_diff[:, None], wi_cos, wi_spec)
    ok = take_diff | spec_ok
    pdf = torch.where(ok, disney_pdf(wo, wi, a), 0.0)
    f = torch.where((reflect_ng_fn(wi) & ok)[:, None], disney_f(m, wo, wi),
                    0.0)
    return dict(wi=wi, f=f, pdf=pdf)


# -------------------------------------------------------------- the scene
class Scene(dp.Scene):
    """The triangles, their Disney rows, the instances' bounding spheres
    and the point lights, on the device."""

    def __init__(self, tris: dict, device):
        f = len(tris["p"])
        super().__init__(dict(p=tris["p"], n=tris["n"], kd=tris["kd"],
                              emit=np.zeros((f, 3), np.float32),
                              light=np.full(f, -1, np.int64),
                              light_tri=np.zeros(0, np.int64)), device)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self.metallic, self.eta = t(tris["metallic"]), t(tris["eta"])
        rough = t(tris["roughness"])
        self.alpha = torch.clamp_min(rough * rough, 0.001)
        self.light_p, self.light_i = t(tris["light_p"]), t(tris["light_i"])
        self.n_lights = len(tris["light_p"])
        first, count = tris["inst_first"], tris["inst_count"]
        k = np.arange(int(count.max()))
        table = np.where(k < count[:, None], first[:, None] + k, -1)
        corners = tris["p"][np.maximum(table, 0)].astype(np.float64)
        corners = np.where((table >= 0)[..., None, None], corners,
                           corners[:, :1, :1])
        lo = corners.min(axis=(1, 2))
        hi = corners.max(axis=(1, 2))
        centre = 0.5 * (lo + hi)
        radius = np.sqrt(((corners - centre[:, None, None]) ** 2)
                         .sum(-1)).max(axis=(1, 2))
        radius = radius * (1.0 + PAD_REL) + PAD_ABS
        self.inst_tri = t(table)
        self.centre = t(centre.astype(np.float32))
        self.radius2 = t((radius * radius).astype(np.float32))

    def material(self, tri) -> dict:
        return dict(kd=self.kd[tri], metallic=self.metallic[tri],
                    eta=self.eta[tri], alpha=self.alpha[tri])

    def _pairs(self, o, d, t_max):
        """The (ray, instance) pairs whose sphere meets the ray's segment,
        by ray and then by entry: (ray, instance, entry, rank of the
        instance among the ray's)."""
        n, n_inst = o.shape[0], self.centre.shape[0]
        step = max(1, PAIR_BUDGET // n_inst)
        none = torch.zeros((0,), dtype=torch.int64, device=o.device)
        rays, insts, enters = [none], [none], [none.to(o.dtype)]
        for lo in range(0, n, step):
            oo, dd = o[lo:lo + step], d[lo:lo + step]
            oc = self.centre[None] - oo[:, None]
            d2 = sp.dot(dd, dd)[:, None]
            tc = (oc * dd[:, None]).sum(-1) / d2
            gap = oc - tc[..., None] * dd[:, None]
            dist2 = (gap * gap).sum(-1)
            half = torch.sqrt(torch.clamp_min(self.radius2 - dist2, 0.0)
                              / d2)
            meet = (dist2 <= self.radius2) & (tc + half >= 0.0) & \
                (tc - half <= t_max[lo:lo + step, None])
            ri, ii = torch.nonzero(meet, as_tuple=True)
            rays.append(ri + lo)
            insts.append(ii)
            enters.append(torch.clamp_min((tc - half)[ri, ii], 0.0))
        ray, inst, enter = (torch.cat(x) for x in (rays, insts, enters))
        order = torch.argsort(enter, stable=True)
        order = order[torch.argsort(ray[order], stable=True)]
        ray, inst, enter = ray[order], inst[order], enter[order]
        counts = torch.bincount(ray, minlength=n)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(ray.numel(), device=o.device) - starts[ray]
        return ray, inst, enter, rank

    def _test(self, o, d, t_max, ray, inst):
        """The watertight test of each pair's ray against its instance's
        triangles: (t, (b0, b1, b2), hit, triangle ids), (m, width)."""
        tri = self.inst_tri[inst]
        ids = torch.clamp_min(tri, 0)
        t, b, hit = dp.watertight(o[ray][:, None], d[ray][:, None],
                                  t_max[ray][:, None], self.p0[ids],
                                  self.p1[ids], self.p2[ids])
        return t, b, hit & (tri >= 0), ids

    def closest(self, o, d):
        """(hit, triangle, barycentrics) of each ray's nearest triangle."""
        n, dev = o.shape[0], o.device
        best_t = torch.full((n,), float("inf"), device=dev)
        best_tri = torch.zeros((n,), dtype=torch.int64, device=dev)
        best_b = torch.zeros((n, 3), device=dev)
        inf = torch.full((n,), float("inf"), device=dev)
        ray, inst, enter, rank = self._pairs(o, d, inf)
        width = self.inst_tri.shape[1]
        k = 0
        while True:
            sel = torch.nonzero((rank == k) & (enter <= best_t[ray]))[:, 0]
            if sel.numel() == 0:
                break
            for lo in range(0, sel.numel(), max(1, TEST_BUDGET // width)):
                s = sel[lo:lo + max(1, TEST_BUDGET // width)]
                r = ray[s]
                t, b, hit, ids = self._test(o, d, inf, r, inst[s])
                tc, ic = torch.min(torch.where(hit, t, float("inf")), dim=1)
                better = tc < best_t[r]
                bc = torch.stack([torch.gather(x, 1, ic[:, None])[:, 0]
                                  for x in b], -1)
                best_t[r] = torch.where(better, tc, best_t[r])
                best_tri[r] = torch.where(
                    better, torch.gather(ids, 1, ic[:, None])[:, 0],
                    best_tri[r])
                best_b[r] = torch.where(better[:, None], bc, best_b[r])
            k += 1
        return torch.isfinite(best_t), best_tri, best_b

    def occluded(self, o, d, t_max):
        out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        ray, inst, _, rank = self._pairs(o, d, t_max)
        width = self.inst_tri.shape[1]
        k = 0
        while True:
            sel = torch.nonzero((rank == k) & ~out[ray])[:, 0]
            if sel.numel() == 0:
                break
            for lo in range(0, sel.numel(), max(1, TEST_BUDGET // width)):
                s = sel[lo:lo + max(1, TEST_BUDGET // width)]
                out[ray[s]] |= self._test(o, d, t_max, ray[s],
                                          inst[s])[2].any(dim=1)
            k += 1
        return out


# ------------------------------------------------------------------ paths
def trace(scene: Scene, draws: sobol.Draws, o, d, max_depth: int, q):
    """Radiance of each lane's path from the camera ray (o, d)."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    big_l = torch.zeros((n, 3), dtype=f32, device=dev)
    lane = torch.arange(n, device=dev)  # the wave's lanes still running
    beta = torch.ones((n, 3), dtype=f32, device=dev)
    pick = 1.0 / max(scene.n_lights, 1)
    for bounce in range(max_depth):
        if lane.numel() == 0:
            break
        base = 2 + DIMS_PER_BOUNCE * bounce
        dr = sobol.Draws(draws.index[lane], draws.scramble[lane])
        k = lane.numel()
        hit, tri, b = scene.closest(o, d)

        v = sp.vertex(scene, tri, b)
        v["p"], v["err"] = q(v["p"]), q(v["err"])
        m = scene.material(tri)
        wo = -d
        wo_l = sp.to_local(v, wo)

        # the light's sample
        if scene.n_lights > 1:
            light = torch.clamp_max(
                (dr.one(base + 4) * float(scene.n_lights)).to(torch.int64),
                scene.n_lights - 1)
        else:
            light = torch.zeros((k,), dtype=torch.int64, device=dev)
        lp = scene.light_p[light]
        to_l = lp - v["p"]
        dist2 = torch.clamp_min(sp.dot(to_l, to_l), 1e-30)
        wi = to_l / sp.sqrt(dist2)[:, None]
        li = scene.light_i[light] / dist2[:, None]
        lpdf = torch.ones((k,), dtype=f32, device=dev)
        reflect_ng = sp.dot(wi, v["ng"]) * sp.dot(wo, v["ng"]) > 0.0
        f, _ = eval_f_pdf(m, wo_l, sp.to_local(v, wi), reflect_ng)
        f = f * torch.abs(sp.dot(wi, v["ns"]))[:, None]
        pdf_eff = lpdf * pick
        useful = hit & (lpdf > 0.0) & (li != 0.0).any(-1) & \
            (f != 0.0).any(-1)
        contrib = f * li * torch.ones_like(lpdf)[:, None] / \
            torch.clamp_min(pdf_eff, 1e-20)[:, None]
        ask = torch.nonzero(useful)[:, 0]
        so = sp.offset_origin(v["p"][ask], v["err"][ask], v["ng"][ask],
                              lp[ask] - v["p"][ask])
        lit = torch.zeros_like(useful)
        lit[ask] = ~scene.occluded(so, lp[ask] - so, torch.full(
            (ask.numel(),), 1.0 - dp.SHADOW_EPSILON, dtype=f32, device=dev))
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
        o = q(torch.where(go[:, None],
                          sp.offset_origin(v["p"], v["err"], v["ng"], wi), o))
        d = q(torch.where(go[:, None], wi, d))

        if bounce > RR_START_DEPTH:
            mx = beta.max(-1).values
            gate = go & (mx < 1.0)
            q_rr = torch.clamp_min(1.0 - mx, 0.05)
            kill = gate & (dr.one(base + 7) < q_rr)
            beta = q(torch.where((gate & ~kill)[:, None],
                                 beta / (1.0 - q_rr)[:, None], beta))
            go = go & ~kill

        keep = torch.nonzero(go)[:, 0]
        lane, o, d, beta = (x[keep] for x in (lane, o, d, beta))
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
    if config["scene"]["loader"] != "gltf":
        raise ValueError("the reference reads glTF scenes")

    def q(x):
        return x if control is None else x.to(control).to(torch.float32)

    dev = torch.device(device)
    scene = Scene(flake_scene.load(config["scene"]["path"]), dev)
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
        radiance = trace(scene, draws, q(o), q(d), traffic["max_depth"], q)
        dp.splat(film, q(radiance), pxi, pyi, jx, jy, row, q)
    return q(film)
