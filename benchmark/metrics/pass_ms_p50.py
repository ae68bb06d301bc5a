"""The median wall time of the window's passes (ms): the refresh a
viewer's user waits for.

A pass runs from the previous callback (or its job's start) to its own
callback, where the viewer shows the film: every pass of the window
counts, the first of each job with its job's start. The median, and not
a tail: a 51 s window holds about 40 refreshes of 4 spp, so a 90th
percentile would rest on four passes.
"""

import statistics


def compute(rec):
    if not rec["passes"]:
        return None
    return statistics.median((e - s) * 1e3 for s, e in rec["passes"])
