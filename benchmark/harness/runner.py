"""One run of one cell: set-up, warm-up, the window, the readers, the check.

``run_cell`` does the work on a given device and returns the result's
fields; ``main`` is the command line: it refuses a machine without the
cards the cell asks for, and a process that has loaded JAX or the JAX
package, and prints the compared numbers (standard error) and the result
(the last line of standard output).
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import subprocess
import sys
import time

from . import check, manifest, trace, workload
from .program import Program

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_tpu")


class Tracer:
    """Profiles passes ``after + 1 .. after + n`` of the window (counted
    from its start) with host and device activities.

    A per-layer reader that needs more than the trace (a counter of the
    program's, a spy on one of its calls) defines ``attach(program,
    tracer)``: it is called before the warm-up, may append callables to
    ``tracer.on_start`` and ``tracer.on_stop`` (run as the traced passes
    begin and end) and ``tracer.on_close`` (run after the window), and
    keeps what it reads in ``tracer.extra[<its name>]``, which its
    ``compute`` finds in ``records["trace"]["extra"]``."""

    def __init__(self, program: Program, after: int, n: int, readers=()):
        import torch

        self.torch = torch
        self.after, self.n = after, n
        self.done = False
        self.prof = self.span = None
        self.on_start, self.on_stop, self.on_close = [], [], []
        self.extra: dict = {}
        for _, module in readers:
            if hasattr(module, "attach"):
                module.attach(program, self)

    def on_pass(self, index: int):
        from torch.profiler import ProfilerActivity, profile

        if index == self.after:
            for fn in self.on_start:
                fn()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.span = self.torch.profiler.record_function(trace.SPAN)
            self.span.__enter__()
        elif index == self.after + self.n:
            self.span.__exit__(None, None, None)
            self.prof.stop()
            for fn in self.on_stop:
                fn()
            self.done = True

    def close(self):
        for fn in self.on_close:
            fn()

    def records(self, samples_per_pass: int) -> dict:
        device, host, span = trace.raw_events(self.prof)
        out = trace.summarise(device, host, span)
        out.update(passes=self.n, samples=self.n * samples_per_pass,
                   extra=self.extra)
        return out


def _power_limit_w():
    """The card's power limit (W), as nvidia-smi reads it; None where it
    cannot."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(res.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def reference_film(config: dict, traffic: dict, view: dict, tiles,
                   frames: int, device, control=None):
    """The reference's film of sample frames [0, frames) of the view at
    the tiles, read as ``check.read_tiles`` reads the program's."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    film = manifest.reference(config).render_tiles(
        config, traffic, view, tiles, frames, device, control=control)
    return check.read_tiles(film, tiles, traffic["check"]["tile_px"])


def run_cell(config: dict, traffic: dict, limits: dict, metric_entries: list,
             seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_start: float | None = None,
             log=sys.stderr) -> dict:
    """One run; returns the result's fields (``check`` last)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    on_cuda = torch.device(device).type == "cuda"
    with open(config["scene"]["path"], "rb") as fh:
        if hashlib.sha256(fh.read()).hexdigest() != config["scene"]["sha256"]:
            raise ValueError(f"{config['scene']['path']} is not the scene "
                             f"file the configuration names")

    def views(job):
        return workload.moved_camera(config, traffic, seed, job)

    tiles = workload.check_tiles(seed, traffic)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    program = Program(config, traffic, device)
    readers = [(e["name"], manifest.load_metric(e["name"]))
               for e in metric_entries]
    units = {e["name"]: e["unit"] for e in metric_entries}
    tracer = Tracer(program, traffic["trace_after_passes"],
                    traffic["trace_passes"], readers) if trace_on else None
    try:
        program.warm_up(views(0))
        program.sync()
        setup_s = time.perf_counter() - t_start
        win = program.window(seconds, views, tracer)
    finally:
        if tracer is not None:
            tracer.close()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    records = dict(passes=win.passes, window=(win.start, win.end),
                   samples_per_pass=win.samples_per_pass, setup_s=setup_s,
                   peak_mem_bytes=peak, jobs_done=win.jobs_done, trace=None)
    if tracer is not None:
        records["trace"] = tracer.records(win.samples_per_pass)
    prog_tiles = check.read_tiles(win.film, tiles,
                                  traffic["check"]["tile_px"])
    frames, job = win.film_frames, win.film_job
    n_passes = len(win.passes)
    del program, win, tracer
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref_tiles = reference_film(config, traffic, views(job), tiles, frames,
                               device)
    numbers = check.compare(prog_tiles, ref_tiles)
    correct, compared = check.judge(numbers, limits)
    print(f"reference: job {job}, {frames} frames, {len(tiles)} tiles, "
          f"{time.perf_counter() - t_ref:.1f} s", file=log)
    start, end = records["window"]
    spans = [round((e - s) * 1e3, 1) for s, e in records["passes"]]
    print(f"window: {n_passes} passes, {records['jobs_done']} jobs, "
          f"{end - start:.3f} s, setup {setup_s:.3f} s, pass ms "
          f"{spans[:80]}", file=log)

    metrics = {}
    for name, module in readers:
        value = module.compute(records)
        if value is not None:
            metrics[name] = dict(value=value, unit=units[name])
    dev_info = dict(platform="gpu" if on_cuda else "cpu",
                    kind=torch.cuda.get_device_name() if on_cuda else "cpu",
                    count=1, memory_peak_bytes=peak)
    if on_cuda:
        dev_info["power_limit_w"] = _power_limit_w()
    result = dict(correct=correct, attempted=n_passes, failed=0,
                  metrics=metrics, device=dev_info)
    if records["trace"] is not None:
        tr = records["trace"]
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["span_s"])
        result["breakdown"] = dict(device_ops=tr["device_ops_top"],
                                   idle_gaps=tr["idle_gaps"])
    result["check"] = compared
    return result


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = manifest.load_manifest()
    cell = manifest.cell(man, args.workload)
    config = manifest.config(man, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    entries = manifest.metrics_for(man, cell["name"], bool(args.trace))

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(config, traffic, limits, entries, args.seed,
                      args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
