"""The MCLR local-SGD kernel's share of its roofline: the least time of
each round's launch at the iterations it executed (``costs.mclr_sgd_work``)
over the kernel's traced time, in percent."""
from fedbench import costs

KERNEL = "fed_sgd_cluster_kernel"


def read(o):
    c = o.counters
    if o.trace is None or "traced_budgets" not in c:
        return None
    seconds = o.trace.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    least_ms = 0.0
    for b in c["traced_budgets"]:
        flops, nbytes = costs.mclr_sgd_work(int(b.sum()), c["K"], c["max_n"],
                                            c["feat"], c["C"], c["B"],
                                            c["max_iters"])
        least_ms += costs.bound(nbytes, flops)
    return 100.0 * least_ms * 1e-3 / seconds
