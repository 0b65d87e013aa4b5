"""Model FLOPs of the local-SGD iterations the window executed (the
budgets each round pulled) over the window's host-clock time at the
H100's float32 rate outside the tensor cores (the configuration computes
in float32), in percent."""
from fedbench import costs


def read(o):
    c = o.counters
    if not c.get("window_s") or "executed_iters" not in c:
        return None
    flops = costs.mclr_model_flops(c["executed_iters"], c["B"], c["feat"],
                                   c["C"])
    return 100.0 * flops / (c["window_s"] * costs.FP32_FLOPS_PER_S)
