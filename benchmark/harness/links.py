"""Device operations of a traced run by the ``pt::`` spans around their
launch, for readers that look below a layer: the work of a span that
names no layer, and a hand kernel's device time.

Each device operation of the traced span (``trace.SPAN``) is linked, as
``spans.summarise`` links it, by the correlation id of the runtime call
that issued it, to the chain of ``pt::`` spans holding that call
(``spans.raw``, ``spans.chains``). ``summarise`` keeps:

- ``bsdf_ops``: operations with a ``pt::bsdf:<material>`` span in their
  chain (``ops/bsdf.py``'s metal, substrate and glass branches), and
  ``bsdf_spans``, the number of such spans that start in the traced span;
- ``k2_kernels`` / ``k2_s``: the K2 kernels (``K2_KERNEL`` in their name)
  whose innermost span is ``pt::k:bvhw``, and their summed device time.

``attach(tracer)`` registers ``read_tracer`` once, to run after the
window, as ``spans.attach`` does; it leaves the dict in
``tracer.extra["links"]`` (None where no pass was traced).
"""

from __future__ import annotations

from . import spans

BSDF_PREFIX = "pt::bsdf:"
K2_SPAN = "pt::k:bvhw"
K2_KERNEL = "bvhw_kernel"


def summarise(device, runtime, span_list, span) -> dict:
    lo, hi = span
    inside = [d for d in device if lo <= d[1] <= hi]
    times = [runtime.get(d[3]) for d in inside]
    bsdf_ops = k2_kernels = k2_ns = 0
    for (name, start, end, _), chain in zip(inside,
                                            spans.chains(span_list, times)):
        bsdf_ops += any(n.startswith(BSDF_PREFIX) for n in chain)
        if K2_KERNEL in name and chain and chain[-1] == K2_SPAN:
            k2_kernels += 1
            k2_ns += end - start
    bsdf_spans = sum(n.startswith(BSDF_PREFIX) and lo <= s <= hi
                     for n, s, _ in span_list)
    return dict(bsdf_ops=bsdf_ops, bsdf_spans=bsdf_spans,
                k2_kernels=k2_kernels, k2_s=k2_ns * 1e-9)


def read_tracer(tracer) -> None:
    if tracer.prof is not None and tracer.done:
        tracer.extra["links"] = summarise(*spans.raw(tracer.prof))


def attach(tracer) -> None:
    if "links" not in tracer.extra:
        tracer.extra["links"] = None
        tracer.on_close.append(lambda: read_tracer(tracer))


def found(rec):
    """The links of a traced run, or None where no pass was traced."""
    tr = rec.get("trace")
    return tr.get("extra", {}).get("links") if tr else None
