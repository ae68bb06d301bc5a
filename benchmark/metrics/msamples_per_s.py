"""Camera samples completed in the window over the window's wall time.

The samples are the traffic's pixels x spp of every pass that completed
(never a count of the program's); the time runs from the window's start
to the end of its last pass, on the host's clock.
"""


def compute(rec):
    start, end = rec["window"]
    if not rec["passes"] or end <= start:
        return None
    return len(rec["passes"]) * rec["samples_per_pass"] / (end - start) / 1e6
