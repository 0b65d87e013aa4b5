"""The selective scan backward's share of its roofline: each launch's
least time (``costs.scan_bwd_work`` at one row of the cell's length, the
model's inner width and state) over the traced time of the backward and
its reduction, in percent."""
from fedbench import costs

KERNEL = "selective_scan_bwd_kernel"
REDUCE = "selective_scan_bwd_reduce_kernel"


def read(o):
    c = o.counters
    if o.trace is None or "di" not in c:
        return None
    launches = o.trace.kernel_count(KERNEL)
    seconds = o.trace.kernel_seconds(KERNEL, REDUCE)
    if not launches or seconds <= 0:
        return None
    nbytes, flops, exps = costs.scan_bwd_work(c["rows"], c["S"], c["di"],
                                              c["N"])
    return (100.0 * launches * costs.scan_bound(nbytes, flops, exps) * 1e-3
            / seconds)
