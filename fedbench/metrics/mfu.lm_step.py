"""Model FLOPs of the local steps the window ran (6 N D, N every
parameter, D the steps' tokens; recomputation not counted) over the
window's host-clock time at the H100's dense bf16 rate, in percent."""
from fedbench import costs


def read(o):
    c = o.counters
    if not c.get("tokens") or not c.get("window_s"):
        return None
    flops = costs.lm_train_flops(c["n_params"], c["tokens"])
    return 100.0 * flops / (c["window_s"] * costs.BF16_FLOPS_PER_S)
