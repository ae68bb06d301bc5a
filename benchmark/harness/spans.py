"""The port's ``pt::`` spans in a traced run, read once from the trace.

While a profiler records, the port opens ``record_function`` ranges
named ``pt::...`` (``pathtracer_tpu_torch/utils/spans.py``): a chunk
holds band-frames and its sync; a band-frame holds the sampler, the
camera, the bounces and the film; a bounce holds intersect, shade, nee
and scatter; ``pt::k:<kernel>`` wraps each launch of a hand-written
kernel. They are events of the same trace as the device's operations,
on the same clock.

Each device operation of the traced span (``trace.SPAN``; counted as
``trace.summarise`` counts them) carries the correlation id of the
runtime call that issued it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
...), a host event: a torch op's kernel, copy or set, and a hand-written
kernel, whose launch's runtime call lies inside its ``pt::k:<what>``
span. The innermost span holding that call's start that names a layer
(``LAYERS``) is the operation's layer; ``pt::texture``,
``pt::alpha_cut`` and ``pt::k:*`` name none, so their work counts in the
span around them. Ops under ``pt::bounce`` in no leaf span count as
shading; a shadow query in ``pt::nee`` counts as intersect.
``outside``: linked to a host time in no layer span; ``unlinked``: no
host time.

``attach(tracer)`` (called from each span metric's own ``attach``)
registers ``read_tracer`` once, to run after the window, so that reading
the trace costs none of the window's passes. It leaves in
``tracer.extra["spans"]`` the dict ``summarise`` returns; a program
without spans leaves counts of zero, and the readers return None.
"""

from __future__ import annotations

import re

from . import trace

PREFIX = "pt::"
KERNEL_PREFIX = "pt::k:"
# the span that names each layer; the others name none
LAYERS = {"pt::chunk": "chunk", "pt::chunk_sync": "chunk_sync",
          "pt::callback": "callback", "pt::band_frame": "band_frame",
          "pt::sampler": "sampler", "pt::camera": "camera",
          "pt::bounce": "shading", "pt::shade": "shading",
          "pt::nee": "shading", "pt::scatter": "shading",
          "pt::intersect": "intersect", "pt::film": "film"}
OUTSIDE, UNLINKED = "outside", "unlinked"
# the host events that a device operation's correlation id names: the
# CUDA API calls (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel...)
RUNTIME = re.compile(r"cu(da)?[A-Z]")


def raw(prof):
    """The trace's events as plain tuples: (device [(name, start, end,
    correlation)], runtime {correlation: start}, spans [(name, start,
    end)] of the ``pt::`` ranges, the traced span (start, end))."""
    from torch.autograd import DeviceType

    device, runtime, spans, span = [], {}, [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == trace.SPAN:
                span = (e.start_ns(), e.end_ns())
            elif name.startswith(PREFIX):
                spans.append((name, e.start_ns(), e.end_ns()))
            elif RUNTIME.match(name):
                runtime[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation() and name != trace.SPAN:
            device.append((name, e.start_ns(), e.end_ns(),
                           e.correlation_id()))
    if span is None:
        raise RuntimeError(f"the trace holds no {trace.SPAN} range")
    return device, runtime, spans, span


def chains(spans, times):
    """For each time (None: none), the names of the spans holding it,
    outermost first (spans nest: one thread)."""
    order = sorted(range(len(times)), key=lambda i: (times[i] is None,
                                                     times[i] or 0))
    ordered = sorted(spans, key=lambda s: (s[1], -s[2]))
    out = [()] * len(times)
    stack, k = [], 0
    for i in order:
        t = times[i]
        if t is None:
            break
        while k < len(ordered) and ordered[k][1] <= t:
            while stack and stack[-1][2] <= ordered[k][1]:
                stack.pop()
            stack.append(ordered[k])
            k += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[i] = tuple(s[0] for s in stack)
    return out


def layer_of(chain) -> str:
    """The innermost layer of a chain of span names."""
    for name in reversed(chain):
        if name in LAYERS:
            return LAYERS[name]
    return OUTSIDE


def summarise(device, runtime, spans, span) -> dict:
    """What the span readers need, over the traced span ``span``:

    - ``device_ops``: device operations starting in it; ``ops``:
      {layer: those operations}, with ``outside`` and ``unlinked``;
    - ``in_band_frame`` / ``band_frame_own``: those issued inside a
      band-frame, and those of them in no layer below it;
    - ``hand_launches`` / ``hand_kernels``: the ``pt::k:`` spans that
      start in it, and the operations issued inside one;
    - ``band_frame_ms``: the durations of the band-frames wholly in it;
      ``sync_s``: the summed ``pt::chunk_sync``, clipped to it;
    - ``span_s``: its length (s).
    """
    lo, hi = span
    inside = [d for d in device if lo <= d[1] <= hi]
    times = [runtime.get(d[3]) for d in inside]
    ops: dict = {}
    in_bf = bf_own = hand = 0
    for t, chain in zip(times, chains(spans, times)):
        layer = UNLINKED if t is None else layer_of(chain)
        ops[layer] = ops.get(layer, 0) + 1
        if "pt::band_frame" in chain:
            in_bf += 1
            bf_own += layer == "band_frame"
        hand += any(n.startswith(KERNEL_PREFIX) for n in chain)
    launches = sum(n.startswith(KERNEL_PREFIX) and lo <= s <= hi
                   for n, s, _ in spans)
    band_frame_ms = [(e - s) * 1e-6 for n, s, e in spans
                     if n == "pt::band_frame" and lo <= s and e <= hi]
    sync_s = sum(max(0, min(e, hi) - max(s, lo)) for n, s, e in spans
                 if n == "pt::chunk_sync") * 1e-9
    return dict(device_ops=len(inside), ops=ops, in_band_frame=in_bf,
                band_frame_own=bf_own, hand_launches=launches,
                hand_kernels=hand, band_frame_ms=band_frame_ms,
                sync_s=sync_s, span_s=(hi - lo) * 1e-9)


def read_tracer(tracer) -> None:
    """``summarise`` of the tracer's stopped profile into
    ``tracer.extra["spans"]`` (nothing where no pass was traced)."""
    if tracer.prof is not None and tracer.done:
        tracer.extra["spans"] = summarise(*raw(tracer.prof))


def attach(tracer) -> None:
    """Register ``read_tracer`` with the tracer, once: the first span
    metric's ``attach`` does, the others find ``extra["spans"]`` set."""
    if "spans" not in tracer.extra:
        tracer.extra["spans"] = None
        tracer.on_close.append(lambda: read_tracer(tracer))


def found(rec):
    """The spans' summary of a traced run, or None where the program
    opened no band-frame span (a program without spans)."""
    tr = rec.get("trace")
    got = tr.get("extra", {}).get("spans") if tr else None
    if not got or not got["band_frame_ms"]:
        return None
    return got
