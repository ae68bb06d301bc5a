"""The share (%) of the traced passes' wall span that the host spends
in the chunks' syncs: the summed span ``pt::chunk_sync`` (the chunk's
reads of its ray and non-finite counts, where the host waits for the
device to finish the chunk) over the traced span (``harness/spans.py``).
Near 0 while the host issues slower than the device runs; tens of % once
the device is the bound."""

from harness import spans


def attach(program, tracer):
    spans.attach(tracer)


def compute(rec):
    got = spans.found(rec)
    if got is None or got["span_s"] <= 0:
        return None
    return 100.0 * got["sync_s"] / got["span_s"]
