"""The fused cross-entropy backward's share of its roofline: each loss
chunk's least time (``costs.xent_bwd_work``, bf16 tensor-core rate) over
the traced time of its four kernels, in percent."""
from fedbench import costs

KERNELS = ("xent_dlogits_tc_kernel", "xent_dh_tc_kernel",
           "xent_dh_reduce_kernel", "xent_dw_tc_kernel")


def read(o):
    c = o.counters
    if o.trace is None or "V" not in c:
        return None
    chunks = o.trace.kernel_count(KERNELS[0])
    seconds = o.trace.kernel_seconds(*KERNELS)
    if not chunks or seconds <= 0:
        return None
    T = min(c["loss_chunk"], c["rows"] * c["S"])
    flops, nbytes = costs.xent_bwd_work(T, c["d"], c["V"])
    least = costs.bound(nbytes, flops, costs.BF16_FLOPS_PER_S)
    return 100.0 * chunks * least * 1e-3 / seconds
