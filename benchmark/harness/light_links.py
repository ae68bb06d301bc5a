"""Device operations of a traced run issued inside the port's
``pt::light`` span: the light sampling code (``ops/lights.py``:
``sample_li``, ``pdf_li``), which every scene with a light runs.

Each device operation of the traced span (``trace.SPAN``) is linked, as
``spans.summarise`` links it, by the correlation id of the runtime call
that issued it, to the chain of ``pt::`` spans holding that call
(``spans.raw``, ``spans.chains``). ``summarise`` keeps ``light_ops``, the
operations with ``pt::light`` in their chain, ``light_s``, their summed
device time, and ``light_spans``, the ``pt::light`` spans that start in
the traced span. ``pt::light`` names no layer (``spans.LAYERS``), so these
operations count in the layer around them too.

``attach(tracer)`` registers ``read_tracer`` once, to run after the
window; it leaves the dict in ``tracer.extra["light_links"]`` (None where
no pass was traced).
"""

from __future__ import annotations

from . import spans

LIGHT_SPAN = "pt::light"


def summarise(device, runtime, span_list, span) -> dict:
    lo, hi = span
    inside = [d for d in device if lo <= d[1] <= hi]
    times = [runtime.get(d[3]) for d in inside]
    ops = ns = 0
    for (_, start, end, _), chain in zip(inside,
                                         spans.chains(span_list, times)):
        if LIGHT_SPAN in chain:
            ops += 1
            ns += end - start
    light_spans = sum(n == LIGHT_SPAN and lo <= s <= hi
                      for n, s, _ in span_list)
    return dict(light_ops=ops, light_s=ns * 1e-9, light_spans=light_spans)


def read_tracer(tracer) -> None:
    if tracer.prof is not None and tracer.done:
        tracer.extra["light_links"] = summarise(*spans.raw(tracer.prof))


def attach(tracer) -> None:
    if "light_links" not in tracer.extra:
        tracer.extra["light_links"] = None
        tracer.on_close.append(lambda: read_tracer(tracer))


def found(rec):
    """The light sampling's operations in a traced run, or None where no
    pass was traced or the traced passes opened no ``pt::light`` span."""
    tr = rec.get("trace")
    got = tr.get("extra", {}).get("light_links") if tr else None
    if not got or not got["light_spans"]:
        return None
    return got
