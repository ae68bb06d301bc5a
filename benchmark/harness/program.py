"""The system under test: the port's scene, integrator and render loop.

``Program`` builds what the cell's configuration and traffic name
through the port's own entry points (``scene.mitsuba.load_mitsuba`` or
``scene.gltf.load_gltf``, ``TracedScene.create``, ``PathIntegrator``),
and makes each job's camera with ``core.camera.Camera.create``.
``window`` drives ``PathIntegrator.render_progressive`` job after job
until ``seconds`` have passed, each job with the view the traffic gives
it (a viewer's camera move restarts the render, ``frontend/interactive``;
an offline render takes the next frame), in chunks of ``pass_spp``
samples: one span a pass, from the previous callback (or the job's
start) to this one. Each pass ends synchronised: the integrator reads
its ray counts to the host once a chunk, and the callback waits for the
film it was handed. The window ends at the end of the first pass that
ends past ``seconds``, so it holds every pass it started.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


class _Stop(Exception):
    """Raised from the callback to end ``render_progressive``."""


@dataclasses.dataclass
class Window:
    """What a window did: pass spans (start, end) on the host clock, and
    the film the check reads, with the job it belongs to and the sample
    frames it holds."""

    start: float
    end: float = 0.0
    passes: list = dataclasses.field(default_factory=list)
    samples_per_pass: int = 0
    film: object = None          # the film checked
    film_job: int = 0            # the job it belongs to
    film_frames: int = 0         # the sample frames it holds
    jobs_done: int = 0


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        import torch

        from pathtracer_tpu_torch.integrator import (PathConfig,
                                                     PathIntegrator,
                                                     TracedScene)
        from pathtracer_tpu_torch.scene.gltf import load_gltf
        from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

        self.torch = torch
        self.device = torch.device(device)
        scene = config["scene"]
        loader = {"gltf": load_gltf, "mitsuba": load_mitsuba}[scene["loader"]]
        self.resolution = tuple(traffic["resolution"])
        _, sd, _ = loader(scene["path"], resolution=self.resolution,
                          device=device)
        self.scene = TracedScene.create(sd)
        self.integ = PathIntegrator(
            PathConfig(max_depth=traffic["max_depth"],
                       mis_mode=traffic["mis_mode"],
                       sampler=traffic["sampler"],
                       light_strategy=traffic["light_strategy"]),
            spp=traffic["job_spp"])
        self.pass_spp = traffic["pass_spp"]
        w, h = self.resolution
        self.samples_per_pass = w * h * traffic["pass_spp"]

    def camera(self, view: dict):
        """The port's camera of a view (``workload.moved_camera``)."""
        from pathtracer_tpu_torch.core.camera import Camera

        w, h = self.resolution
        return Camera.create(
            np.asarray(view["cam_to_world"], np.float64), w / h,
            float(view["fovy"]), (w, h), float(view["znear"]),
            float(view["zfar"]))

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def warm_up(self, view: dict):
        """One pass of the cell's own shape, then stop."""
        def stop(film, done):
            self.sync()
            raise _Stop

        try:
            self.integ.render_progressive(self.camera(view), self.scene,
                                          chunk_spp=self.pass_spp,
                                          callback=stop)
        except _Stop:
            pass

    def window(self, seconds: float, views, tracer=None) -> Window:
        """Jobs back to back for ``seconds``, job ``k`` with ``views(k)``.
        ``tracer`` (or None) is told of every pass's end
        (``tracer.on_pass(index)``) and says whether the window may close
        (``tracer.done``)."""
        clock = time.perf_counter
        win = Window(start=clock(), samples_per_pass=self.samples_per_pass)
        mark = [win.start]
        job = 0
        finished = None  # the newest finished job's (film, job)

        def callback(film, done):
            self.sync()
            t = clock()
            win.passes.append((mark[0], t))
            mark[0] = t
            win.film, win.film_job, win.film_frames = film, job, done
            if tracer is not None:
                tracer.on_pass(len(win.passes))
            if t - win.start >= seconds and (tracer is None or tracer.done):
                win.end = t
                raise _Stop

        while not win.end:
            mark[0] = clock()
            try:
                film = self.integ.render_progressive(
                    self.camera(views(job)), self.scene,
                    chunk_spp=self.pass_spp, callback=callback)
            except _Stop:
                break
            win.jobs_done += 1
            finished = (film, job)
            job += 1
        if finished is not None:
            win.film, win.film_job = finished
            win.film_frames = self.integ.spp
        return win
