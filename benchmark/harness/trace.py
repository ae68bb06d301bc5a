"""Reading a torch.profiler trace of whole passes, in memory.

The profiler runs over a fixed number of passes inside the window, with
a ``record_function`` range (``SPAN``) from the first traced pass's start
to the last one's end: that range is the traced wall span, on the trace's
own clock. The raw Kineto events are read without building torch's event
tree (which takes minutes for a pass of ~10^5 device operations): device
operations (kernels, copies, sets; the device-side copies of host ranges
are not work) and host operations, each as (name, start, end) in
nanoseconds.

``summarise`` reduces them to what the metric readers and the result's
``breakdown`` need: the device's busy time (the union of its intervals
within the span), its operation count, the device time by kernel name,
and the idle gaps grouped by the innermost host operation running at
each gap's middle.
"""

from __future__ import annotations

import bisect

SPAN = "benchmark::traced_passes"
NO_HOST_OP = "(no host op)"
TOP = 10


def raw_events(prof):
    """(device [(name, start, end)], host [(name, start, end)], span
    (start, end)) from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CPU:
            if name == SPAN:
                span = (start, end)
            else:
                host.append((name, start, end))
        elif not e.is_user_annotation() and name != SPAN:
            device.append((name, start, end))
    if span is None:
        raise RuntimeError(f"the trace holds no {SPAN} range")
    return device, host, span


def union_intervals(intervals, lo: int, hi: int):
    """Merged, sorted (start, end) intervals clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _innermost(host_sorted, starts, t: float) -> str:
    """The innermost host op running at ``t``: of those that started by
    ``t`` and had not ended, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4096, -1), -1):
        name, s, e = host_sorted[j]
        if e >= t:
            return name
    return NO_HOST_OP


def summarise(device, host, span) -> dict:
    """The trace's numbers over ``span``: ``span_s``, ``busy_s``,
    ``device_ops``, ``kernel_s`` {name: seconds}, and the top ``TOP``
    ``device_ops_top`` and ``idle_gaps`` as [name, seconds] lists."""
    lo, hi = span
    inside = [(n, s, e) for n, s, e in device if lo <= s <= hi]
    merged = union_intervals([(s, e) for _, s, e in inside], lo, hi)
    busy_ns = sum(e - s for s, e in merged)
    kernel_ns: dict = {}
    for n, s, e in inside:
        kernel_ns[n] = kernel_ns.get(n, 0) + (e - s)
    host_sorted = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    gaps: dict = {}
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            name = _innermost(host_sorted, starts, 0.5 * (g0 + g1))
            gaps[name] = gaps.get(name, 0) + (g1 - g0)

    def top(d):
        return [[n[:120], v * 1e-9] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(span_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9,
                device_ops=len(inside),
                kernel_s={n: v * 1e-9 for n, v in kernel_ns.items()},
                device_ops_top=top(kernel_ns), idle_gaps=top(gaps))

