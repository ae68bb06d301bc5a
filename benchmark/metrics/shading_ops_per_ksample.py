"""Device operations of the shading layer in the traced passes per 1,000
camera samples of those passes (the traffic's pixels x spp): those the
host issued inside ``pt::shade``, ``pt::nee`` or ``pt::scatter``, or in
``pt::bounce`` outside every leaf span (``ops/interaction.py``,
``ops/bsdf.py``, ``ops/lights.py``, ``_wave_bounce``); a shadow query's
count as intersect (``harness/spans.py``)."""

from harness import spans


def attach(program, tracer):
    spans.attach(tracer)


def compute(rec):
    got = spans.found(rec)
    if got is None or not rec["trace"]["samples"]:
        return None
    return got["ops"].get("shading", 0) / (rec["trace"]["samples"] / 1000.0)
