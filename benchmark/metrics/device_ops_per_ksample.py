"""Device operations (kernels, copies, sets) of the traced passes per
1,000 camera samples of those passes (the traffic's pixels x spp)."""


def compute(rec):
    tr = rec["trace"]
    if tr is None or not tr["samples"]:
        return None
    return tr["device_ops"] / (tr["samples"] / 1000.0)
