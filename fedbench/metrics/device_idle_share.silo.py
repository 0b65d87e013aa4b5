"""Share of the traced window in which no kernel or copy ran, in
percent."""


def read(o):
    if o.trace is None or o.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - o.trace.busy_s / o.trace.window_s)
