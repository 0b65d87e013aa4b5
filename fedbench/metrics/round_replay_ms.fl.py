"""Device milliseconds a round of the work launched inside the scan
driver's ``fed.block.replay`` spans (the rounds' graph replays), tied to
its launches by the trace's correlation ids: the rounds alone, without
the eval, the injected draws' copies and the stats pull."""
from fedbench.spans import spans


def read(o):
    rounds = o.counters.get("traced_rounds")
    if not rounds or not spans(o.trace, "fed.block.replay"):
        return None
    seconds = o.trace.range_seconds("fed.block.replay")
    if seconds <= 0:
        return None
    return seconds * 1e3 / rounds
