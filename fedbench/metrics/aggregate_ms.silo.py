"""Device milliseconds a round of the work launched inside the silo
round's ``fed.aggregate`` stage range (the FedAvg over the silos' stack),
tied to its launches by the trace's correlation ids."""

STAGE = "fed.aggregate"


def read(o):
    if o.trace is None or not o.counters.get("traced_rounds"):
        return None
    seconds = o.trace.range_seconds(STAGE)
    if seconds <= 0:
        return None
    return seconds * 1e3 / o.counters["traced_rounds"]
