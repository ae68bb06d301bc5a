"""The share (%) of the traced passes' wall span that no device
operation covers: one minus the union of the device intervals over the
span, both from the profiler's trace."""


def compute(rec):
    tr = rec["trace"]
    if tr is None or tr["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
