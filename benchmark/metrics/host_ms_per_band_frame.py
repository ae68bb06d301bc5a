"""The median host time of one band-frame (ms): the port's span
``pt::band_frame``, one row band's one sample frame, from the sampler's
first draw to the film's splat, over the band-frames wholly inside the
traced passes (``harness/spans.py``). The host issues a band-frame's
device operations within it; in a host-bound loop it is the pass's time
over its band-frames."""

import statistics

from harness import spans


def attach(program, tracer):
    spans.attach(tracer)


def compute(rec):
    got = spans.found(rec)
    if got is None or not got["band_frame_ms"]:
        return None
    return statistics.median(got["band_frame_ms"])
