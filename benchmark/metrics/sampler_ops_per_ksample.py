"""Device operations of the sampler layer (the span ``pt::sampler``:
``ops/sobol.py``, ``ops/samplers.py``) in the traced passes per 1,000
camera samples of those passes (the traffic's pixels x spp). Each
operation counts in the innermost layer span its host issued it in
(``harness/spans.py``)."""

from harness import spans


def attach(program, tracer):
    spans.attach(tracer)


def compute(rec):
    got = spans.found(rec)
    if got is None or not rec["trace"]["samples"]:
        return None
    return got["ops"].get("sampler", 0) / (rec["trace"]["samples"] / 1000.0)
