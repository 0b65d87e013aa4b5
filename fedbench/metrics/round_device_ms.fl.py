"""Device milliseconds a round: the union of the traced window's kernels
and copies over its rounds."""


def read(o):
    if o.trace is None or not o.counters.get("traced_rounds"):
        return None
    return o.trace.busy_s * 1e3 / o.counters["traced_rounds"]
