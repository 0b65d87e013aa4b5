"""The cohort-gather kernel's share of its roofline: each launch's least
time (``costs.gather_work``, bytes) over the kernel's traced time, in
percent."""
from fedbench import costs

KERNEL = "fed_gather_kernel"


def read(o):
    c = o.counters
    if o.trace is None or "K" not in c:
        return None
    seconds = o.trace.kernel_seconds(KERNEL)
    launches = o.trace.kernel_count(KERNEL)
    if seconds <= 0 or not launches:
        return None
    flops, nbytes = costs.gather_work(c["K"], c["max_n"], c["feat"])
    return 100.0 * launches * costs.bound(nbytes, flops) * 1e-3 / seconds
