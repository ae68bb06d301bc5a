"""Headless render runner: progressive tev streaming + PNG output.

Port of ``pathtracer_tpu/frontend/headless.py`` (the reference's
``src/headless.rs``): connect to tev (or fall back to one-shot), stream
in-progress film updates while rendering, write ``render.png`` at the
end. The film comes to the host only between sample chunks; checkpoints
go through ``render_progressive(checkpoint=)``.
"""

from __future__ import annotations

import os
import time

import torch

from ..core.film import to_rgb, to_rgb8
from ..integrator import PathIntegrator
from ..utils.image import write_png
from ..utils.logging import get_logger
from .tev import TevClient

log = get_logger("headless")


def output_file(path: str) -> str:
    """``path``, or ``path/render.png`` where it names a directory."""
    return os.path.join(path, "render.png") if os.path.isdir(path) else path


def run(camera, scene, integrator: PathIntegrator, output_path: str,
        server_address: str = "127.0.0.1:14158",
        chunk_spp: int | None = None,
        checkpoint: str | None = None) -> torch.Tensor:
    """Render and save; returns the (H, W, 4) film on the scene's
    device."""
    w, h = camera.resolution
    tev = TevClient(server_address)
    t_start = time.perf_counter()

    def progress(done):
        # per-chunk spp progress with elapsed time and ETA
        el = time.perf_counter() - t_start
        eta = el / max(done, 1) * (integrator.spp - done)
        log.info("progress: %d/%d spp  %.0fs elapsed  ~%.0fs left",
                 done, integrator.spp, el, eta)

    if tev.connected:
        log.info("streaming progressive render to tev at %s", server_address)
        tev.create_image(w, h)

        def callback(film, done):
            tev.update_image(to_rgb(film).cpu().numpy())
            progress(done)

        chunk = chunk_spp or max(1, integrator.spp // 8)
    else:
        log.warning("could not connect to display server, "
                    "falling back to progressive chunked rendering")
        callback = (lambda film, done: progress(done)) \
            if (chunk_spp and chunk_spp < integrator.spp) else None
        chunk = chunk_spp or integrator.spp

    t0 = time.perf_counter()
    film = integrator.render_progressive(camera, scene, chunk_spp=chunk,
                                         callback=callback,
                                         checkpoint=checkpoint)
    seconds = time.perf_counter() - t0
    log.info("rendering took: %.2fs (%.2f Mrays/s)", seconds,
             integrator.last_ray_count / max(seconds, 1e-9) / 1e6)
    if integrator.bad_sample_count:
        log.error("non-finite/negative radiance in %d samples (zeroed)",
                  int(integrator.bad_sample_count))
    if tev.connected:
        tev.update_image(to_rgb(film).cpu().numpy())
        tev.close()

    out = output_file(output_path)
    write_png(out, to_rgb8(film))
    log.info("wrote %s", out)
    return film
