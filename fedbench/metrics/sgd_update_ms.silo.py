"""Device milliseconds of a local step's in-place SGD update: the work
launched inside the window's ``fed.local_step.update`` spans over the
number of ``fed.local_step`` spans."""
from fedbench.spans import spans


def read(o):
    steps = spans(o.trace, "fed.local_step")
    if not steps or not spans(o.trace, "fed.local_step.update"):
        return None
    seconds = o.trace.range_seconds("fed.local_step.update")
    if seconds <= 0:
        return None
    return seconds * 1e3 / len(steps)
