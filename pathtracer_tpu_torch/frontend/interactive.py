"""Interactive viewer: terminal key input + tev display.

Port of ``pathtracer_tpu/frontend/interactive.py``. The reference's
interactive loop (viewer/mod.rs:98-300) drives a wgpu window: camera
controllers move the eye, R re-raytraces, Up/Down double/halve pixel
samples, S saves, T cycles the log level, Escape quits. This viewer keeps
the same interaction loop but reads single keys from the terminal (raw
mode) and shows the progressively rendered film in a running tev. It
renders on the scene's device.

Keys (reference binding in parentheses):
  orbit mode: h/l orbit horizontally, j/k vertically, -/+ zoom
              (mouse drag / scroll)
  fps mode:   w/a/s/d move, space/c up/down, q/e roll (WASD + mouse)
  r           restart the render from sample 0          (R)
  ]/[         double / halve samples per pixel          (Up/Down)
  o           save the current film as PNG              (S)
  t           cycle log level                           (T)
  p           show the raster-preview analogue
  m           toggle wireframe overlay                  (Ctrl-H)
  b           toggle BVH bounds overlay                 (Ctrl-B)
  g           single-pixel debug trace, center pixel    (Ctrl-click)
  ESC or x    quit (writes the final PNG)               (Escape)

The render loop is chunked: after every sample chunk the film streams to
tev and pending keys are applied; camera motion restarts the
accumulation (the reference re-raytraces on R; here motion implies R).
"""

from __future__ import annotations

import dataclasses
import select
import sys
import time

import numpy as np

from ..core.controller import (FirstPersonCameraController,
                               OrbitalCameraController)
from ..core.film import to_rgb, to_rgb8
from ..utils.image import write_png
from ..utils.logging import cycle_level, get_logger
from .tev import TevClient

log = get_logger("viewer")


def preview_frame(camera, scene, wire: bool = False):
    """Instant preview: one primary-visibility wave shaded as
    albedo x |n . v| -- the stand-in for the reference viewer's
    rasterized phong preview (viewer/shaders/phong.rs; ViewerState::
    RasterScene). With ``wire`` the triangle edges are highlighted from
    the hit barycentrics -- the reference's wireframe debug pass
    (viewer/wireframe.rs:17-61, Ctrl-H) without a raster pipeline. The
    wave runs on the scene's device through its route's kernel.
    Returns (H, W, 3) float rgb, a writable host array."""
    import torch

    from ..core import math as pm
    from ..core.camera import generate_rays
    from ..integrator import TracedScene, _scene_intersect
    from ..ops import bsdf as bx
    from ..ops import interaction as ia

    if not isinstance(scene, TracedScene):
        scene = TracedScene.create(scene)
    dev = scene.device
    w, h = camera.resolution
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    p_film = torch.as_tensor(
        np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], -1),
        dtype=torch.float32, device=dev)
    o, d = generate_rays(*camera.ray_params(dev), p_film)
    hit = _scene_intersect(scene, o, d, torch.inf)
    it = ia.make_interaction(scene.data, o, d, hit, scene.tri_attr)
    mp = bx.gather_params(scene.data, it["material"], it["uv"],
                          mat_attr=scene.mat_attr, has_tex=scene.has_tex,
                          tex_channels=scene.tex_channels,
                          image_tex=scene.image_tex)
    shade = mp["kd"] * torch.abs(pm.dot(it["ns"], -d))[..., None] \
        + ia.emitted_radiance(it, -d)
    if wire:
        # distance to the nearest edge in barycentric space; the ref pass
        # draws GL lines -- same visual, no raster pipeline needed
        edge = torch.amin(hit["b"], dim=-1) < 0.02
        shade = torch.where((edge & hit["valid"])[..., None],
                            torch.tensor([0.1, 1.0, 0.25], device=dev),
                            shade)
    rgb = torch.where(hit["valid"][..., None], shade, 0.05)
    # overlays (draw_bvh_bounds) draw into the host copy
    return rgb.reshape(h, w, 3).cpu().numpy()


def bvh_level_boxes(scene, levels: int = 3):
    """Host-side walk of the BVH32 table's top ``levels`` levels →
    list of (level, bmin (3,), bmax (3,)) child AABBs. The interior rows
    self-describe (accel/bvhw.py layout: slabs component-major, [192]
    child base row, [193]/[194] occupancy halves), so no rebuild is
    needed — the overlay reads the same table the traversal gathers."""
    if getattr(scene, "bw_rows", None) is None:
        return []
    rows = scene.bw_rows.cpu().numpy()
    boxes = []
    frontier = [0]
    for lvl in range(levels):
        nxt = []
        for r in frontier:
            row = rows[r]
            if row[255] != 0.0:  # leaf row: no child slabs
                continue
            occ = np.uint32(row[193]) | (np.uint32(row[194]) << np.uint32(16))
            base = int(row[192])
            rank = 0
            for slot in range(32):
                if not (int(occ) >> slot) & 1:
                    continue
                bmin = np.array([row[slot], row[32 + slot], row[64 + slot]])
                bmax = np.array([row[96 + slot], row[128 + slot],
                                 row[160 + slot]])
                boxes.append((lvl, bmin, bmax))
                nxt.append(base + rank)
                rank += 1
        frontier = nxt
    return boxes


_LEVEL_COLORS = np.asarray([[1.0, 0.25, 0.2], [1.0, 0.8, 0.1],
                            [0.2, 0.6, 1.0], [0.7, 0.3, 1.0]], np.float32)

_BOX_EDGES = [(a, b) for a in range(8) for b in range(8)
              if a < b and bin(a ^ b).count("1") == 1]  # 12 AABB edges


def project_points(camera, pts):
    """World points (N, 3) → raster xy (N, 2) + in-front mask (N,).

    Inverts the camera's generate_rays chain: world → camera via the
    rigid cam_to_world inverse, camera → raster via
    inv(raster_to_camera) with perspective divide."""
    c2w = camera.cam_to_world
    pc = (np.asarray(pts, np.float64) - c2w[:3, 3]) @ c2w[:3, :3]
    c2r = np.linalg.inv(camera.raster_to_camera)
    ph = np.concatenate([pc, np.ones((len(pc), 1))], axis=1) @ c2r.T
    w_ = ph[:, 3]
    in_front = (pc[:, 2] < 0) & (np.abs(w_) > 1e-12)
    xy = ph[:, :2] / np.where(np.abs(w_) > 1e-12, w_, 1.0)[:, None]
    return xy, in_front


def draw_bvh_bounds(img, camera, scene, levels: int = 3):
    """Overlay the top BVH levels' AABB edges on ``img`` (H, W, 3),
    in place — the reference viewer's bounds debug pass
    (viewer/bounds.rs:12-114, Ctrl-B), line-drawn host-side instead of
    through a wgpu line-list pipeline. Level colors cycle
    red/yellow/blue/violet. Returns img (a copy when the input buffer is
    read-only, e.g. a bare device-array view)."""
    if not img.flags.writeable:
        img = img.copy()
    h, w = img.shape[:2]
    for lvl, bmin, bmax in bvh_level_boxes(scene, levels):
        corners = np.array([[bmin[0] if (i >> 0) & 1 == 0 else bmax[0],
                             bmin[1] if (i >> 1) & 1 == 0 else bmax[1],
                             bmin[2] if (i >> 2) & 1 == 0 else bmax[2]]
                            for i in range(8)])
        if not np.isfinite(corners).all():
            continue
        xy, ok = project_points(camera, corners)
        color = _LEVEL_COLORS[lvl % len(_LEVEL_COLORS)]
        for a, b in _BOX_EDGES:
            if not (ok[a] and ok[b]):
                continue
            n = int(max(2, min(4 * max(w, h),
                               np.linalg.norm(xy[b] - xy[a]) * 2)))
            t = np.linspace(0.0, 1.0, n)[:, None]
            p = xy[a] * (1 - t) + xy[b] * t
            px = np.round(p[:, 0]).astype(int)
            py = np.round(p[:, 1]).astype(int)
            m = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            img[py[m], px[m]] = color
    return img


@dataclasses.dataclass
class ViewerState:
    camera: object
    spp: int
    controller: object
    dirty: bool = False   # camera moved -> restart accumulation
    restart: bool = False  # explicit R
    save: bool = False
    quit: bool = False
    preview: bool = False  # 'p': show the raster-preview analogue
    wire: bool = False     # 'm': wireframe overlay (ref Ctrl-H)
    bounds: bool = False   # 'b': BVH AABB overlay (ref Ctrl-B)
    debug_pixel: bool = False  # 'g': single-pixel trace (ref Ctrl-click)


def dispatch_key(state: ViewerState, key: str) -> ViewerState:
    """Apply one key to the viewer state (pure-ish: controller objects
    accumulate motion; render loop applies them via update_camera)."""
    ctl = state.controller
    if key in ("\x1b", "x"):
        state.quit = True
    elif key == "r":
        state.restart = True
    elif key == "]":
        state.spp *= 2
        state.restart = True  # re-render at the new spp (ref Up key)
        log.info("pixel samples: %d", state.spp)
    elif key == "[":
        state.spp = max(1, state.spp // 2)
        state.restart = True
        log.info("pixel samples: %d", state.spp)
    elif key == "o":
        state.save = True
    elif key == "p":
        state.preview = True
    elif key == "m":
        state.wire = not state.wire
        state.preview = True
        log.info("wireframe overlay: %s", "on" if state.wire else "off")
    elif key == "b":
        state.bounds = not state.bounds
        state.preview = True
        log.info("BVH bounds overlay: %s", "on" if state.bounds else "off")
    elif key == "g":
        state.debug_pixel = True
    elif key == "t":
        cycle_level()
    elif isinstance(ctl, OrbitalCameraController):
        step = 30.0  # degrees per press (mouse-drag analogue)
        if key == "h":
            ctl.process_mouse(step, 0.0)
        elif key == "l":
            ctl.process_mouse(-step, 0.0)
        elif key == "j":
            ctl.process_mouse(0.0, step)
        elif key == "k":
            ctl.process_mouse(0.0, -step)
        elif key == "+" or key == "=":
            ctl.process_scroll(-0.5)
        elif key == "-":
            ctl.process_scroll(0.5)
        else:
            return state
        state.dirty = True
    elif isinstance(ctl, FirstPersonCameraController):
        look = {"i": (0.0, -15.0), "k": (0.0, 15.0),
                "j": (15.0, 0.0), "l": (-15.0, 0.0)}
        if key == "c":
            key = "shift"
        if key in look:
            ctl.process_mouse(*look[key])
            state.dirty = True
        elif ctl.process_key(key):
            state.dirty = True
    return state


def _pending_keys(timeout: float = 0.0):
    """Non-blocking single-character reads from stdin (raw mode). A
    closed stdin (piped key scripts) reads as ESC so the viewer exits
    instead of idling forever. Terminal escape SEQUENCES are translated:
    Up/Down arrows -> ']'/'[' (the reference's spp keys); other CSI
    sequences are swallowed so a stray arrow can't quit the viewer —
    only a BARE ESC quits."""
    keys = []
    while True:
        try:
            r, _, _ = select.select([sys.stdin], [], [], timeout)
        except (OSError, ValueError):
            return keys + ["\x1b"]
        if not r:
            return keys
        ch = sys.stdin.read(1)
        if not ch:  # EOF
            return keys + ["\x1b"]
        if ch == "\x1b":
            r2, _, _ = select.select([sys.stdin], [], [], 0.02)
            if not r2:
                keys.append("\x1b")  # bare ESC
            else:
                nxt = sys.stdin.read(1)
                if nxt in ("[", "O"):
                    code = sys.stdin.read(1)
                    keys.append({"A": "]", "B": "["}.get(code, ""))
                # else: alt-<key> chord — swallow
            timeout = 0.0
            continue
        keys.append(ch)
        timeout = 0.0


def run(camera, scene, integrator, output_path: str,
        server_address: str = "127.0.0.1:14158",
        controller: str = "orbit", pivot=None,
        max_frames: int | None = None):
    """Interactive loop. ``max_frames`` bounds the outer loop for tests."""
    from ..integrator import TracedScene
    if not isinstance(scene, TracedScene):
        scene = TracedScene.create(scene)
    p0 = scene.data.p0.cpu().numpy()
    extent = float(np.linalg.norm(p0.max(0) - p0.min(0)))
    if pivot is None:
        pivot = 0.5 * (p0.min(0) + p0.max(0))
    # unit speeds: key presses apply their nominal step exactly once per
    # update_camera(dt=1.0) (30-degree orbit, x0.5/x1.5 zoom, 0.1-rad
    # roll) — larger speeds multiply INTO the step and can alias to a
    # full revolution
    ctl = (OrbitalCameraController(pivot, orbit_speed=1.0, zoom_speed=1.0)
           if controller == "orbit"
           else FirstPersonCameraController(
               rotate_sensitivity=1.0,
               move_sensitivity=max(0.03 * extent, 1e-3)))
    state = ViewerState(camera=camera, spp=integrator.spp, controller=ctl)
    w, h = camera.resolution
    tev = TevClient(server_address)
    if tev.connected:
        tev.create_image(w, h)
        log.info("interactive viewer streaming to tev at %s",
                 server_address)
    else:
        log.warning("tev unreachable; interactive render continues "
                    "headless (keys still work, 'o' saves PNG)")

    raw = False
    if sys.stdin.isatty():
        import termios
        import tty
        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        raw = True
    film = None
    frames = 0
    try:
        while not state.quit:
            if max_frames is not None and frames >= max_frames:
                break
            frames += 1
            state.dirty = state.restart = False
            integrator.spp = state.spp

            def cb(f, done, _state=state):
                nonlocal film
                film = f
                if tev.connected:
                    tev.update_image(to_rgb(f).cpu().numpy())
                for key in _pending_keys():
                    dispatch_key(_state, key)
                if _state.save and film is not None:
                    write_png(output_path, to_rgb8(film))
                    log.info("saved %s", output_path)
                    _state.save = False
                if _state.dirty or _state.restart or _state.quit:
                    raise _Restart()

            try:
                film = integrator.render_progressive(
                    state.camera, scene,
                    chunk_spp=max(1, min(4, state.spp)), callback=cb)
            except _Restart:
                pass
            if state.quit:
                break
            if state.dirty:
                state.camera = ctl.update_camera(state.camera, dt=1.0)
                if tev.connected:  # instant feedback while moving
                    tev.update_image(_preview_img(state, scene))
                continue
            if state.restart:
                continue
            # render finished at current spp: idle-wait for input
            while not (state.dirty or state.restart or state.quit):
                keys = _pending_keys(timeout=0.25)
                for key in keys:
                    dispatch_key(state, key)
                if state.save and film is not None:
                    write_png(output_path, to_rgb8(film))
                    log.info("saved %s", output_path)
                    state.save = False
                if state.preview:
                    if tev.connected:
                        tev.update_image(_preview_img(state, scene))
                    state.preview = False
                if state.debug_pixel:
                    _debug_center_pixel(state, scene, integrator)
                    state.debug_pixel = False
                if max_frames is not None:
                    break
            if state.dirty:
                state.camera = ctl.update_camera(state.camera, dt=1.0)
    finally:
        if raw:
            termios.tcsetattr(fd, termios.TCSADRAIN, saved)
        if tev.connected:
            tev.close()
    if film is not None:
        write_png(output_path, to_rgb8(film))
        log.info("wrote %s", output_path)
    return film


def _preview_img(state: ViewerState, scene):
    """Compose the preview with any active debug overlays."""
    img = preview_frame(state.camera, scene, wire=state.wire)
    if state.bounds:
        draw_bvh_bounds(img, state.camera, scene)
    return img


def _debug_center_pixel(state: ViewerState, scene, integrator):
    """'g' key: re-trace every sample of the center pixel and log the
    per-sample radiance — the reference's Ctrl-click single-pixel debug
    (viewer/mod.rs:304-318 → integrator.rs:505-534). Terminal viewers
    have no cursor position, so the crosshair is the frame center."""
    from .debug import render_single_pixel
    w, h = state.camera.resolution
    render_single_pixel(state.camera, scene, integrator.cfg,
                        (w // 2, h // 2), min(16, state.spp))


class _Restart(Exception):
    """Raised inside the chunk callback to abandon the current
    accumulation (camera moved / spp changed / quit)."""
