"""K2's share (%) of its roofline in the traced passes: the least time
the card could take for the bytes K2's launches move, over the summed
device time of the K2 kernels linked to their ``pt::k:bvhw`` span
(``harness/links.py``).

The bytes are the program's count, ``ops/cuda/bvhw_cu.BYTES`` (each
launch: every ray read once, 28 B; its hit written once, 21 B, an
any-hit query's 1 B; the BVH32 table read once, 1 KiB a row; under graph
replay the capture's tally a replay), read as the traced passes begin
and end. K2 is bound by bytes at that count: it does no arithmetic the
count charges. The peak is the H100 SXM's 3.35 TB/s. None for a program
without the count, or where no K2 kernel ran."""

from harness import links

PEAK_BYTES_PER_S = 3.35e12
NAME = "k2_roofline_pct"


def attach(program, tracer):
    links.attach(tracer)
    try:
        from pathtracer_tpu_torch.ops.cuda import bvhw_cu
    except ImportError:
        return
    if not hasattr(bvhw_cu, "BYTES"):
        return
    mark = {}
    tracer.on_start.append(lambda: mark.update(start=bvhw_cu.BYTES))
    tracer.on_stop.append(
        lambda: tracer.extra.update({NAME: bvhw_cu.BYTES - mark["start"]}))


def compute(rec):
    got = links.found(rec)
    moved = rec["trace"]["extra"].get(NAME) if rec.get("trace") else None
    if got is None or moved is None or got["k2_s"] <= 0:
        return None
    return 100.0 * moved / PEAK_BYTES_PER_S / got["k2_s"]
