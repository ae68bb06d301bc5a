"""The share (%) of the environment light's full-width work in the
traced passes that a live lane uses: the program's counters
``PathIntegrator.env_lanes`` (``run``: the lanes the environment's code
evaluates, every call at the wave's full width, tallied on the host;
``used``: the live lanes whose environment result enters the estimate,
those that escape and those whose light sample takes the environment,
counted on the device and read at each chunk's sync), read as the traced
passes begin and end. What evaluating the environment on the lanes that
use it alone could save. None for a program without the counters, or
where the environment ran on no lane."""

NAME = "env_live_pct"


def attach(program, tracer):
    integ = getattr(program, "integ", None)
    counts = getattr(integ, "env_lanes", None)
    if not isinstance(counts, dict):
        return
    mark = {}
    tracer.on_start.append(lambda: mark.update(counts))
    tracer.on_stop.append(lambda: tracer.extra.update(
        {NAME: {k: counts[k] - mark[k] for k in ("used", "run")}}))


def compute(rec):
    got = rec["trace"]["extra"].get(NAME) if rec.get("trace") else None
    if not got or got["run"] <= 0:
        return None
    return 100.0 * got["used"] / got["run"]
