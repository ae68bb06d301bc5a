"""Device operations of the BSDF branches in the traced passes per 1,000
camera samples of those passes (the traffic's pixels x spp): those the
host issued inside a ``pt::bsdf:<material>`` span, the METAL, SUBSTRATE
and GLASS branches of ``ops/bsdf.eval_f_pdf`` and ``ops/bsdf.sample_f``
(``harness/links.py``). A subset of ``shading_ops_per_ksample``. None
where the traced passes open no such span (a program without them, or
a scene of none of these materials)."""

from harness import links


def attach(program, tracer):
    links.attach(tracer)


def compute(rec):
    got = links.found(rec)
    if got is None or not got["bsdf_spans"] or not rec["trace"]["samples"]:
        return None
    return got["bsdf_ops"] / (rec["trace"]["samples"] / 1000.0)
