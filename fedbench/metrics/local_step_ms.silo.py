"""Device milliseconds a local step: the work launched inside the
window's ``fed.local_step`` spans (autograd's backward thread included:
launches are tied to a span by time, on every thread, and to their
device records by correlation id) over the number of those spans."""
from fedbench.spans import spans


def read(o):
    steps = spans(o.trace, "fed.local_step")
    if not steps:
        return None
    seconds = o.trace.range_seconds("fed.local_step")
    if seconds <= 0:
        return None
    return seconds * 1e3 / len(steps)
