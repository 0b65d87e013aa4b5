"""The yardstick's cost arithmetic: the H100's published rates and the
least work each measured kernel and model step needs.

Frozen copy of the work functions and rates of
``src/repro_torch/roofline/analysis.py`` at commit
510ac229c19f024cd45ce40e03b24ade1eaa7a3e (``bound``, ``scan_bound``,
``gather_work``, ``mclr_sgd_work``, ``scan_bwd_work``, ``xent_bwd_work``,
the rates), plus the model-FLOP counts of the benchmark's own cells.  The
program's copy may change; this one does not, so that a roofline share
read by a later change is measured against the same work.
"""
from __future__ import annotations

#: H100 SXM data sheet: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM data sheet: float32 FLOP/s outside the tensor cores
FP32_FLOPS_PER_S = 67e12
#: H100 SXM data sheet: dense bf16 tensor-core FLOP/s
BF16_FLOPS_PER_S = 989e12
#: exp2 on the special-function units: 16 results per clock per SM on 132
#: SMs at the H100 SXM's 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> float:
    """The least time in ms: the larger of the bytes over the HBM rate and
    the FLOPs over ``flops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s) * 1e3


def scan_bound(nbytes: float, flops: float, exps: float) -> float:
    """The scan's least time in ms: the largest of its bytes over the
    memory rate, its float32 FLOPs over the CUDA cores' rate and its exps
    over the special-function units' rate, which run beside each other."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S,
               exps / SFU_PER_S) * 1e3


def gather_work(K, max_n, feat, itemsize=4):
    """Cohort gather: (FLOPs, bytes).  Reads and writes K max_n rows of
    ``feat`` elements, the labels (read, written) and the mask, and the
    starts and counts."""
    return 0, (2 * K * max_n * feat * itemsize + 3 * K * max_n * 4
               + 2 * K * 4)


def mclr_sgd_work(executed, K, max_n, feat, C, B, max_iters):
    """MCLR local SGD: (FLOPs, bytes).  Per executed iteration the forward
    and the two gradient products (4 B feat C), the update (2 feat C) and
    the softmax (8 B C); reads x, y, idx, w0, b0, ns and n_iters, writes
    every client's w, b and loss."""
    flops = executed * (4 * B * feat * C + 2 * feat * C + 8 * B * C)
    nbytes = (K * max_n * feat * 4 + K * max_n * 4 + K * max_iters * B * 4
              + (feat * C + C) * 4 + 2 * K * 4 + K * (feat * C + C + 1) * 4)
    return flops, nbytes


def scan_bwd_work(B, S, d, N):
    """(bytes, FLOPs, exps) the least any scan backward can do: read dt,
    x, gy, B, C, A, h0 and ghT once and write ddt, dx, dB, dC, dA and dh0
    once; per state and step recompute h, one exp, the lam step and its
    carry, and the dC, dB, lam B, lam h products and their sums; per
    channel and step dt*x, dx and ddt."""
    nbytes = 4 * (5 * B * S * d + 4 * B * S * N + 2 * d * N + 3 * B * d * N)
    return nbytes, 19 * B * S * d * N + 4 * B * S * d, B * S * d * N


def xent_bwd_work(T, d, V, itemsize=2):
    """Cross-entropy backward: (FLOPs, bytes).  The logits, dh and dW
    products; reads h, W, labels, lse and g, writes dh and dW."""
    return 3 * 2 * T * d * V, 2 * itemsize * (T * d + d * V) + 12 * T


def mclr_model_flops(executed, B, feat, C):
    """Model FLOPs of ``executed`` MCLR local-SGD iterations: the forward
    product and the weight-gradient product, 2 B feat C each."""
    return executed * 4 * B * feat * C


def lm_train_flops(n_params, tokens):
    """Model FLOPs of training on ``tokens``: 6 N D, N every parameter
    (``model_flops_estimate``'s arithmetic), no recompute counted."""
    return 6.0 * n_params * tokens
