"""Device operations of the light sampling in the traced passes per 1,000
camera samples of those passes (the traffic's pixels x spp): those the
host issued inside a ``pt::light`` span (``harness/light_links.py``:
``ops/lights.py``'s ``sample_li`` and ``pdf_li``), a subset of
``shading_ops_per_ksample``. The same read gives their summed device
time, which ``compute`` writes to standard error beside the traced
passes' busy time. None where the traced passes open no such span (a
program without it)."""

import sys

from harness import light_links


def attach(program, tracer):
    light_links.attach(tracer)


def compute(rec):
    got = light_links.found(rec)
    samples = rec["trace"]["samples"] if rec.get("trace") else 0
    if got is None or not samples:
        return None
    busy = rec["trace"].get("busy_s") or 0.0
    share = f"{100.0 * got['light_s'] / busy:.2f} %" if busy > 0 else "-"
    print(f"light: {got['light_ops']} ops, {got['light_s']:.6f} s of device "
          f"time, {share} of the traced busy time", file=sys.stderr)
    return got["light_ops"] / (samples / 1000.0)
