"""Device operations of the environment light in the traced passes per
1,000 camera samples of those passes (the traffic's pixels x spp): those
the host issued inside a ``pt::env`` span (``harness/env_links.py``), a
subset of ``shading_ops_per_ksample``. The same read gives their summed
device time, which ``compute`` writes to standard error beside the
traced passes' busy time. None where the traced passes open no such span
(a program without it, or a scene without an environment)."""

import sys

from harness import env_links


def attach(program, tracer):
    env_links.attach(tracer)


def compute(rec):
    got = env_links.found(rec)
    samples = rec["trace"]["samples"] if rec.get("trace") else 0
    if got is None or not samples:
        return None
    busy = rec["trace"].get("busy_s") or 0.0
    share = f"{100.0 * got['env_s'] / busy:.2f} %" if busy > 0 else "-"
    print(f"env: {got['env_ops']} ops, {got['env_s']:.6f} s of device "
          f"time, {share} of the traced busy time", file=sys.stderr)
    return got["env_ops"] / (samples / 1000.0)
