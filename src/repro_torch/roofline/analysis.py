"""The H100 hardware model, the kernels' bound formulas, and the roofline
terms of a traced step: the port's counterpart of
``repro/roofline/analysis.py``.

    compute term    = FLOPs / peak FLOP/s        (per device)
    memory term     = bytes / HBM bytes/s        (per device)
    collective term = sum of wire bytes / the bandwidth of each
                      collective's link           (per device)

Every rate below is the NVIDIA H100 SXM data sheet's (or derived from
its clocks and unit counts), never a measurement.  The costs are per
device: ``launch.steps.trace_step`` traces one device's share of a step
(``roofline.costs``).

The kernels' bound formulas live here too: each returns the (FLOPs,
bytes) that ``bound`` turns into the least time the card could take.
``chip_smoke.py`` reports every kernel's bound from them, and the cost
counter (``roofline.costs``) charges each kernel launch with the same
numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: H100 SXM data sheet: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM data sheet: float32 FLOP/s outside the tensor cores
FP32_FLOPS_PER_S = 67e12
#: H100 SXM data sheet: dense bf16 tensor-core FLOP/s (the compute term's
#: peak, as the reference's roofline uses its chip's bf16 peak)
BF16_FLOPS_PER_S = 989e12
PEAK_FLOPS = BF16_FLOPS_PER_S
#: exp2 on the special-function units: 16 results per clock per SM (CUDA
#: C++ programming guide, arithmetic throughput, compute capability 9.0)
#: on 132 SMs at the H100 SXM's 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
#: GPUs of one HGX H100 node, joined all to all by NVLink 4
GPUS_PER_NODE = 8
#: data sheet bytes/s per GPU and direction: NVLink 4 inside a node
#: (900 GB/s both ways), one 400 Gb/s network port per GPU between nodes
LINK_BYTES_PER_S = {"nvlink": 450e9, "network": 50e9}


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the FLOPs over ``flops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(nbytes: float, flops: float, exps: float):
    """The scan's bound: the largest of its bytes over the memory rate, its
    float32 flop over the CUDA cores' rate and its exps over the
    special-function units' rate, which run beside each other -> (ms,
    bound_by, {"bytes": ms, "operations": ms, "exp": ms}).  An exp bound
    is reported as bound by operations (they are, on the SFUs)."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / FP32_FLOPS_PER_S * 1e3,
             "exp": exps / SFU_PER_S * 1e3}
    ms = max(parts.values())
    return ms, ("bytes" if parts["bytes"] == ms else "operations"), parts


# ---------------------------------------------------------------------------
# the kernels' work: (flops, bytes), each input read once and each output
# written once
# ---------------------------------------------------------------------------


def attention_pairs(S: int, T: int, causal: bool, window: int = 0) -> int:
    """Unmasked (q, k) pairs of one (batch row, head): query i (from
    position 0) sees keys j < T with j <= i when causal and j > i - window
    when ``window`` > 0."""
    import numpy as np
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(i, T - 1) if causal else np.full_like(i, T - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_fwd_work(B, S, T, Hq, Hkv, hd, causal=True, window=0, itemsize=2):
    """Flash forward: q . k and p v, 2 hd flop each per unmasked pair;
    reads q, k, v, writes out and the float32 lse."""
    pairs = B * Hq * attention_pairs(S, T, causal, window)
    flops = 4 * hd * pairs
    nbytes = itemsize * (2 * B * S * Hq * hd + 2 * B * T * Hkv * hd) \
        + 4 * B * Hq * S
    return flops, nbytes


def flash_bwd_work(B, S, T, Hq, Hkv, hd, causal=True, window=0, itemsize=2):
    """Flash backward (FlashAttention-2): s, dp, dv, dk and dq, 2 hd flop
    each per unmasked pair; reads q, out, do, k, v and lse, writes dq, dk
    and dv."""
    pairs = B * Hq * attention_pairs(S, T, causal, window)
    flops = 10 * hd * pairs
    nbytes = itemsize * (4 * B * S * Hq * hd + 4 * B * T * Hkv * hd) \
        + 4 * B * Hq * S
    return flops, nbytes


def xent_fwd_work(T, d, V, itemsize=2):
    """Cross-entropy forward: the 2 T d V flop logits product; reads h and
    W, and 8 T bytes of labels and loss."""
    return 2 * T * d * V, itemsize * (T * d + d * V) + 8 * T


def xent_bwd_work(T, d, V, itemsize=2):
    """Cross-entropy backward: the logits, dh and dW products; reads h, W,
    labels, lse and g, writes dh and dW."""
    return 3 * 2 * T * d * V, 2 * itemsize * (T * d + d * V) + 12 * T


def scan_work(B, S, d, N):
    """(bytes, flop, exps) of one scan: dt, x, y, B, C, A, h0, hT once;
    per state and step dt*A, the h update (3) and the y fma (2), one exp."""
    nbytes = 4 * (3 * B * S * d + 2 * B * S * N + d * N + 2 * B * d * N)
    return nbytes, 6 * B * S * d * N, B * S * d * N


def gather_work(K, max_n, feat, itemsize=4):
    """Cohort gather: reads and writes K max_n rows of ``feat`` elements,
    the labels (read, written) and the mask, and the starts and counts."""
    return 0, (2 * K * max_n * feat * itemsize + 3 * K * max_n * 4
               + 2 * K * 4)


def mclr_sgd_work(executed, K, max_n, feat, C, B, max_iters):
    """MCLR local SGD: per executed iteration the forward and the two
    gradient products (4 B feat C), the update (2 feat C) and the softmax
    (8 B C); reads x, y, idx, w0, b0, ns and n_iters, writes every
    client's w, b and loss."""
    flops = executed * (4 * B * feat * C + 2 * feat * C + 8 * B * C)
    nbytes = (K * max_n * feat * 4 + K * max_n * 4 + K * max_iters * B * 4
              + (feat * C + C) * 4 + 2 * K * 4 + K * (feat * C + C + 1) * 4)
    return flops, nbytes


def dense_sgd_work(executed, K, max_n, feat, H, C, B, max_iters):
    """Dense-MLP local SGD: per executed iteration the two layers'
    forward and backward products (4 B feat H + 6 B H C); reads x, y,
    idx, the four params, ns and n_iters, writes every client's params
    and loss."""
    flops = executed * (4 * B * feat * H + 6 * B * H * C)
    n_params = feat * H + H + H * C + C
    nbytes = (K * max_n * feat * 4 + K * max_n * 4 + K * max_iters * B * 4
              + n_params * 4 + 2 * K * 4 + K * (n_params + 1) * 4)
    return flops, nbytes


def compress_work(K, P):
    """Top-k + int8 compression: reads the float32 rows, writes the int8
    rows and the scales."""
    return 0, K * P * (4 + 1) + 4 * K


def pitched_work(d, V, src_itemsize, dst_itemsize):
    """The cross-entropy's pitched W: reads W, writes a [d, ceil8(V)]
    buffer."""
    return 0, d * V * src_itemsize + d * (-(-V // 8) * 8) * dst_itemsize


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops: float
    bytes_accessed: float
    collective_bytes: float
    collective_breakdown: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float = 0.0       # 6*N*D (dense) / 6*N_active*D (MoE)
    useful_ratio: float = 0.0      # model_flops / (devices * FLOPs)
    bytes_per_device: float = 0.0  # argument + peak live bytes
    notes: str = ""

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.flops:.3e} | {self.bytes_accessed:.3e} | "
                f"{self.collective_bytes:.3e} | "
                f"{self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} | "
                f"{self.t_collective*1e3:.2f} | {self.bottleneck} | "
                f"{self.useful_ratio:.2f} | {self.bytes_per_device/2**30:.2f} |")


def collective_seconds(cost) -> float:
    """The collective term of a ``StepCost``: each link's wire bytes over
    that link's bandwidth."""
    return sum(b / LINK_BYTES_PER_S[link]
               for link, b in cost.collective_links.items())


def roofline_terms(cost, n_devices: int, *, arch: str = "", shape: str = "",
                   mesh: str = "", model_flops: float = 0.0,
                   bytes_per_device: float = 0.0) -> RooflineReport:
    """The three terms of a per-device ``roofline.costs.StepCost`` and the
    largest of them."""
    t_c = cost.flops / PEAK_FLOPS
    t_m = cost.bytes_accessed / HBM_BYTES_PER_S
    t_x = collective_seconds(cost)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    useful = 0.0
    if model_flops and cost.flops:
        useful = model_flops / (n_devices * cost.flops)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh,
        flops=cost.flops, bytes_accessed=cost.bytes_accessed,
        collective_bytes=cost.collective_bytes,
        collective_breakdown=dict(cost.collective_breakdown),
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful, bytes_per_device=bytes_per_device)


def model_flops_estimate(cfg, shape) -> float:
    """6 N D for training, 2 N D for prefill and decode (D: the tokens of
    the step, one a sequence in decode), N the parameters of
    ``models.api.abstract_params`` less an MoE's inactive experts."""
    from repro_torch.models.api import abstract_params, build_model
    from repro_torch.tree import tree_leaves
    aparams = abstract_params(build_model(cfg))
    total = sum(x.numel() for x in tree_leaves(aparams))
    if cfg.n_experts:
        period = cfg.attn_period or 1
        moe_positions = sum(1 for p in range(period) if cfg.is_moe_layer(p))
        n_moe_layers = (cfg.n_layers // period) * moe_positions
        per_expert = 3 * cfg.d_model * cfg.d_ff
        inactive = n_moe_layers * (cfg.n_experts - cfg.experts_per_token) \
            * per_expert
        total = total - inactive
    if shape.kind == "train":
        return 6.0 * total * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * total * shape.global_batch * shape.seq_len
    return 2.0 * total * shape.global_batch

