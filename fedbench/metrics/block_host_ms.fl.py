"""Host milliseconds a block of the scan driver spends with no round in
flight: the mean over the window's ``fed.block`` spans of the span's
length less its ``fed.block.replay`` and ``fed.block.pull`` children."""
from fedbench.spans import inside, spans


def read(o):
    blocks = spans(o.trace, "fed.block")
    if not blocks:
        return None
    busy = spans(o.trace, "fed.block.replay") + spans(o.trace,
                                                      "fed.block.pull")
    return 1e3 * sum((e - s) - inside(busy, (s, e))
                     for s, e in blocks) / len(blocks)
