"""Device operations of a traced run issued inside the port's ``pt::env``
span: the environment light's code (``ops/lights.py``: ``env_le``,
``env_pdf_li``, ``_env_sample_li``), which a scene without an
environment never runs.

Each device operation of the traced span (``trace.SPAN``) is linked, as
``spans.summarise`` links it, by the correlation id of the runtime call
that issued it, to the chain of ``pt::`` spans holding that call
(``spans.raw``, ``spans.chains``). ``summarise`` keeps ``env_ops``, the
operations with ``pt::env`` in their chain, ``env_s``, their summed
device time, and ``env_spans``, the ``pt::env`` spans that start in the
traced span. ``pt::env`` names no layer (``spans.LAYERS``), so these
operations count in the layer around them too.

``attach(tracer)`` registers ``read_tracer`` once, to run after the
window; it leaves the dict in ``tracer.extra["env_links"]`` (None where
no pass was traced).
"""

from __future__ import annotations

from . import spans

ENV_SPAN = "pt::env"


def summarise(device, runtime, span_list, span) -> dict:
    lo, hi = span
    inside = [d for d in device if lo <= d[1] <= hi]
    times = [runtime.get(d[3]) for d in inside]
    ops = ns = 0
    for (_, start, end, _), chain in zip(inside,
                                         spans.chains(span_list, times)):
        if ENV_SPAN in chain:
            ops += 1
            ns += end - start
    env_spans = sum(n == ENV_SPAN and lo <= s <= hi for n, s, _ in span_list)
    return dict(env_ops=ops, env_s=ns * 1e-9, env_spans=env_spans)


def read_tracer(tracer) -> None:
    if tracer.prof is not None and tracer.done:
        tracer.extra["env_links"] = summarise(*spans.raw(tracer.prof))


def attach(tracer) -> None:
    if "env_links" not in tracer.extra:
        tracer.extra["env_links"] = None
        tracer.on_close.append(lambda: read_tracer(tracer))


def found(rec):
    """The environment's operations in a traced run, or None where no pass
    was traced or the traced passes opened no ``pt::env`` span."""
    tr = rec.get("trace")
    got = tr.get("extra", {}).get("env_links") if tr else None
    if not got or not got["env_spans"]:
        return None
    return got
