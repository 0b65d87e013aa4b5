"""Host milliseconds a block of the scan driver spends on its injected
inputs: the mean over the window's ``fed.block`` spans of their
``fed.block.inputs`` (the draws stacked) and ``fed.block.upload``
(their pinned copies) children."""
from fedbench.spans import inside, spans


def read(o):
    blocks = spans(o.trace, "fed.block")
    if not blocks:
        return None
    parts = spans(o.trace, "fed.block.inputs") + spans(o.trace,
                                                       "fed.block.upload")
    return 1e3 * sum(inside(parts, b) for b in blocks) / len(blocks)
