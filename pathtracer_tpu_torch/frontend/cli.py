"""Command line of the port: the reference's flag surface
(src/main.rs:36-52), the JAX package's additions, and ``--device``.

    python -m pathtracer_tpu_torch.frontend.cli SCENE -o OUT [-s SPP]
        [-r WxH] [-d MAX_DEPTH] [-l LEVEL] [-m MODULES] [--default_lights]
        [--headless] [--server ADDR] [--mesh N] [--checkpoint PATH]
        [--single_pixel X,Y] [--device cuda|cpu]

It renders on the CUDA card unless ``--device cpu`` is given. ``--mesh
N`` spawns N ranks of one torch.distributed group (one a card, or N
processes on the CPU) and rank 0 writes the PNG; ``--profile DIR``
writes a torch.profiler trace (Chrome JSON) of the render into DIR and
logs the live lanes a bounce. ``--mesh`` with ``--profile`` or
``--checkpoint`` is refused (the reference ignores the two there).
"""

from __future__ import annotations

import argparse
import os
import sys

DEFAULT_RESOLUTION = (640, 480)  # ref common/mod.rs:14
MAX_DEPTH = 15  # ref main.rs default


def parse_resolution(s: str):
    for sep in ("x", "X", ","):
        if sep in s:
            a, b = s.split(sep, 1)
            return int(a), int(b)
    raise ValueError(f"bad resolution: {s}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch",
        description="path tracer (PyTorch, CUDA kernels)")
    p.add_argument("scene", help="input scene (.xml mitsuba / .gltf/.glb)")
    p.add_argument("-o", "--output", required=True,
                   help="output directory or file for renders")
    p.add_argument("-s", "--samples", type=int, default=1,
                   help="samples per pixel")
    p.add_argument("-r", "--resolution", default=None,
                   help="render resolution WxH (default 640x480)")
    p.add_argument("-d", "--max_depth", type=int, default=MAX_DEPTH,
                   help="maximum path depth")
    p.add_argument("-l", "--log_level", default="INFO")
    p.add_argument("-m", "--module_log", default="all",
                   help="comma-separated module names to log")
    p.add_argument("--default_lights", action="store_true",
                   help="add default environment light to the scene")
    p.add_argument("--headless", action="store_true",
                   help="run without interactive viewer (the default; "
                        "kept for flag parity)")
    p.add_argument("--interactive", default=None, nargs="?",
                   const="orbit", choices=("orbit", "fps"),
                   help="interactive viewer: terminal keys drive the "
                        "camera, frames stream to tev (ref viewer loop; "
                        "orbit = mouse-orbit analogue, fps = WASD)")
    p.add_argument("--server", default="127.0.0.1:14158",
                   help="tev server address for remote preview")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the render over N ranks, one a device "
                        "(0 = one process)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file (.npz) for resumable renders")
    p.add_argument("--single_pixel", default=None,
                   help="debug: trace one pixel X,Y and print radiance "
                        "(ref render_single_pixel)")
    p.add_argument("--chunk_spp", type=int, default=None,
                   help="samples per progressive chunk")
    p.add_argument("--filter", default="gaussian",
                   choices=("gaussian", "triangle", "lanczos"),
                   help="film reconstruction filter (lanczos = the "
                        "windowed sinc the reference declares but left "
                        "todo!(), filter.rs:17-36)")
    p.add_argument("--mis", default="ref",
                   choices=("ref", "onesample"),
                   help="MIS estimator: 'ref' (default) re-intersects the "
                        "BSDF branch like the reference; 'onesample' "
                        "reuses the continuation ray (pbrt-v4 form, one "
                        "traversal fewer per bounce)")
    p.add_argument("--lighttrace", type=int, default=0, metavar="PATHS",
                   help="render with the adjoint light tracer instead of "
                        "the path tracer, emitting PATHS light paths "
                        "(sample_le-based; the reference declares but "
                        "never implements emission sampling)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render to "
                        "DIR (Chrome trace JSON) and log per-bounce "
                        "wavefront occupancy")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on: 'cuda' (a card; "
                        "--mesh puts rank r on cuda:r) or 'cpu'")
    return p


def load_scene(path: str, resolution, default_lights: bool, device):
    if path.endswith(".xml"):
        from ..scene.mitsuba import load_mitsuba
        camera, scene, settings = load_mitsuba(path, resolution,
                                               device=device)
    elif path.endswith((".gltf", ".glb")):
        from ..scene.gltf import load_gltf
        camera, scene, settings = load_gltf(path, resolution,
                                            default_lights=default_lights,
                                            device=device)
    else:
        raise ValueError(f"unsupported scene format: {path}")
    return camera, scene, settings


def _mesh_rank(device, scene_path, resolution, default_lights, cfg, spp,
               filter_kind, output):
    """One rank of ``--mesh``: load the scene on the rank's device, render
    its share, and on rank 0 write the PNG."""
    import torch.distributed as dist

    from ..core.film import to_rgb8
    from ..parallel.mesh import make_mesh, render_sharded
    from ..utils.image import write_png
    from ..utils.logging import get_logger
    from .headless import output_file

    camera, scene, _ = load_scene(scene_path, resolution, default_lights,
                                  device)
    film = render_sharded(camera, scene, make_mesh(dist.get_world_size()),
                          cfg, spp=spp, filter_kind=filter_kind)
    if dist.get_rank() == 0:
        out = output_file(output)
        write_png(out, to_rgb8(film))
        get_logger("cli").info("wrote %s", out)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # the reference's --mesh branch drops these two without a word
    mesh = args.mesh and not (args.single_pixel or args.lighttrace)
    if mesh and (args.profile or args.checkpoint):
        parser.error("--profile and --checkpoint do not combine with --mesh")

    from ..utils.logging import cycle_level, get_logger, init_logging
    allowed = None if args.module_log == "all" else \
        set(args.module_log.split(","))
    init_logging(args.log_level, allowed)
    log = get_logger("cli")

    try:
        resolution = parse_resolution(args.resolution) \
            if args.resolution else DEFAULT_RESOLUTION
    except ValueError:
        log.warning("failed parsing resolution string, falling back to "
                    "default resolution")
        resolution = DEFAULT_RESOLUTION

    # runtime log-level switching (ref slog_atomic bound to the T key,
    # main.rs:65-66 + viewer/mod.rs:199-212): headless analogue is
    # SIGUSR1 -- each signal cycles the root level INFO<->TRACE(DEBUG)
    import signal
    try:
        signal.signal(signal.SIGUSR1, lambda _sig, _frm: cycle_level())
    except (ValueError, AttributeError):  # non-main thread / platform
        pass

    from ..integrator import PathConfig, PathIntegrator, TracedScene
    cfg = PathConfig(max_depth=args.max_depth, mis_mode=args.mis)

    if mesh:
        # each rank loads the scene on its own device (the reference
        # checks --single_pixel and --lighttrace first)
        from ..parallel.mesh import launch
        launch(args.mesh, _mesh_rank, args.scene, resolution,
               args.default_lights, cfg, args.samples, args.filter,
               args.output, device=args.device)
        return 0

    camera, scene, settings = load_scene(args.scene, resolution,
                                         args.default_lights, args.device)
    log.debug("scene settings: %s", settings)
    traced = TracedScene.create(scene)

    if args.single_pixel:
        x, y = (int(v) for v in args.single_pixel.split(","))
        from .debug import render_single_pixel
        render_single_pixel(camera, traced, cfg, (x, y), args.samples)
        return 0

    from .headless import output_file, run
    if args.lighttrace:
        from ..core.film import to_rgb8
        from ..integrator_lt import LightTracer
        from ..utils.image import write_png
        ltr = LightTracer(cfg, paths=args.lighttrace)
        film = ltr.render(camera, traced)
        out = output_file(args.output)
        write_png(out, to_rgb8(film))
        log.info("light-traced %d paths -> %s", ltr.paths, out)
        return 0

    integ = PathIntegrator(cfg, spp=args.samples, filter_kind=args.filter)

    if args.interactive and not args.headless:
        from .interactive import run as run_interactive
        run_interactive(camera, traced, integ, output_file(args.output),
                        args.server, controller=args.interactive)
        return 0

    if args.profile:
        # one torch.profiler trace around the render plus wavefront
        # queue-occupancy counters per bounce depth
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if traced.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            run(camera, traced, integ, args.output, args.server,
                chunk_spp=args.chunk_spp, checkpoint=args.checkpoint)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        occ = integ.bounce_occupancy
        total = max(occ[0], 1.0)
        log.info("profile trace written to %s", trace)
        for depth, n in enumerate(occ):
            log.info("bounce %2d: %12.0f live lanes (%.1f%%)", depth, n,
                     100.0 * n / total)
    else:
        run(camera, traced, integ, args.output, args.server,
            chunk_spp=args.chunk_spp, checkpoint=args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
