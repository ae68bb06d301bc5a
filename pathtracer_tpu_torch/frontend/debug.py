"""Single-pixel debug harness.

Port of ``pathtracer_tpu/frontend/debug.py`` (the reference's
``render_single_pixel``, wired to Ctrl-click in its viewer): re-trace
every sample of one pixel and log the per-sample radiance. It runs on the
scene's device, through the kernel of the scene's route (K1 or K2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as pm
from ..core.camera import generate_rays
from ..core.film import sample_bounds
from ..integrator import PathConfig, TracedScene, trace_wave
from ..ops import sobol as sb
from ..utils.logging import get_logger

log = get_logger("integrator")


def render_single_pixel(camera, scene, cfg: PathConfig, pixel,
                        spp: int) -> torch.Tensor:
    """The radiance of each of the pixel's ``spp`` (rounded up to a power
    of two) Sobol samples: a (spp, 3) tensor on the scene's device."""
    if not isinstance(scene, TracedScene):
        scene = TracedScene.create(scene)
    dev = scene.device
    w, h = camera.resolution
    (x0, y0), (x1, y1) = sample_bounds(w, h)
    spp = pm.round_up_pow2(spp)
    domain = sb.SobolDomain.create((x0, y0), (x1, y1), spp)
    px = np.full(spp, pixel[0], np.int32)
    py = np.full(spp, pixel[1], np.int32)
    scramble, b_base = sb.pixel_statics(domain, px, py)
    inv_lo, inv_hi = sb.vdc_inv_rows(domain, dev)
    pack = sb.sm32_device(dev)
    r2c, rot, pos = camera.ray_params(dev)

    # one lane per sample index; each lane gets its own sobol index
    b_base = torch.as_tensor(b_base.astype(np.int64), device=dev)
    lo, hi = [], []
    for s in range(spp):
        flo, fhi, fdelta = sb.frame_statics(domain, s)
        l_, h_ = sb.sobol_index(b_base[s:s + 1], int(fdelta), int(flo),
                                int(fhi), inv_lo, inv_hi)
        lo.append(l_)
        hi.append(h_)
    lo, hi = torch.cat(lo), torch.cat(hi)
    scr = torch.as_tensor(scramble.astype(np.int64), device=dev)
    # dims 0/1 unscrambled, as band_frame draws the camera jitter, so the
    # debug pixel re-traces the film's samples
    s01 = sb.sobol_sample_dim2(lo, hi, 0, torch.zeros_like(scr), pack)
    pxf = torch.as_tensor(px, dtype=torch.float32, device=dev)
    pyf = torch.as_tensor(py, dtype=torch.float32, device=dev)
    one_minus = float(pm.ONE_MINUS_EPSILON)
    jx = torch.clamp(s01[..., 0] * domain.resolution + domain.p_min[0]
                     - pxf, 0.0, one_minus)
    jy = torch.clamp(s01[..., 1] * domain.resolution + domain.p_min[1]
                     - pyf, 0.0, one_minus)
    p_film = torch.stack([pxf + jx, pyf + jy], dim=-1)
    log.info("render single pixel: %s (%d samples)", pixel, spp)
    o, d = generate_rays(r2c, rot, pos, p_film)
    for i in range(spp):
        log.debug("sample %d: p_film=%s ray o=%s d=%s", i,
                  p_film[i].tolist(), o[i].tolist(), d[i].tolist())

    def draw(dim):
        return sb.sobol_sample_dim(lo, hi, dim, scr, pack)

    def draw2(dim):
        return sb.sobol_sample_dim2(lo, hi, dim, scr, pack)

    radiance, rays, _bad = trace_wave(scene, cfg, draw, draw2, o, d)
    for i in range(spp):
        log.info("sample %d: L = %s", i, radiance[i].tolist())
    log.info("mean L = %s (%d rays traced)", radiance.mean(0).tolist(),
             int(rays))
    return radiance
