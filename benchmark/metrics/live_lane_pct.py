"""The share (%) of the bounce loop's lane-bounces in the traced passes
whose lane was live: the program's counters
``PathIntegrator.lane_bounces`` (``live``: the live lanes at each
bounce's start, counted on the device and read at each chunk's sync;
``run``: every lane of every band-frame, padding lanes too, at each of
its max_depth + 1 bounces, as the loop runs them all), read as the
traced passes begin and end. What shading only the live lanes could
save. None for a program without the counters."""

NAME = "live_lane_pct"


def attach(program, tracer):
    integ = getattr(program, "integ", None)
    counts = getattr(integ, "lane_bounces", None)
    if not isinstance(counts, dict):
        return
    mark = {}
    tracer.on_start.append(lambda: mark.update(counts))
    tracer.on_stop.append(lambda: tracer.extra.update(
        {NAME: {k: counts[k] - mark[k] for k in ("live", "run")}}))


def compute(rec):
    got = rec["trace"]["extra"].get(NAME) if rec.get("trace") else None
    if not got or got["run"] <= 0:
        return None
    return 100.0 * got["live"] / got["run"]
