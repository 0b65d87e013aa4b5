"""Public kernel ops of the port and the fused-SGD eligibility rule.

Every op is forward-only.  Federated rounds are never differentiated
through (the local-SGD kernels compute their gradients in closed form), and
the model ops serve: prefill and decode differentiate nothing (the
backward of flash attention comes with the training slice).  Each op goes to its wrapper, which runs the plain
version on a CPU tensor and the hand-written kernel on a CUDA tensor.
"""
from __future__ import annotations

import math

from repro_torch.kernels import (fed_compress, fed_gather, fed_local_sgd,
                                 flash_attention as fa)
from repro_torch.kernels import fed_local_sgd_dense as dense_sgd
from repro_torch.kernels import selective_scan as ss


def fed_cohort_gather(flat_x, flat_y, starts, ns, max_n: int):
    """Fused gather + mask over the packed federation.  ``flat_x`` may have
    any feature shape; it is flattened to [rows, feat] for the kernel and
    the gathered x comes back as [K, max_n, ...feat].

    flat_x/flat_y must carry >= max_n rows of tail slack after the last
    client's samples (``FederatedDataset.packed`` pads at upload)."""
    feat_shape = tuple(flat_x.shape[1:])
    feat = math.prod(feat_shape)
    x, y, mask = fed_gather.fed_cohort_gather(
        flat_x.reshape(flat_x.shape[0], feat), flat_y, starts, ns, max_n)
    return x.reshape((x.shape[0], max_n) + feat_shape), y, mask


def fed_local_sgd_mclr(x, y, idx, w0, b0, ns, n_iters, lr: float,
                       prox_mu: float = 0.0):
    """Fused masked budgeted MCLR local SGD.
    Returns (w_k [K, d, C], b_k [K, C], losses [K])."""
    return fed_local_sgd.fed_local_sgd_mclr(x, y, idx, w0, b0, ns, n_iters,
                                            lr, prox_mu)


def fed_local_sgd_dense(x, y, idx, w1, b1, w2, b2, ns, n_iters, lr: float,
                        prox_mu: float = 0.0):
    """Fused masked budgeted dense-MLP (tanh) local SGD.  Returns
    (w1_k [K, d, H], b1_k [K, H], w2_k [K, H, C], b2_k [K, C], losses [K])."""
    return dense_sgd.fed_local_sgd_dense(
        x, y, idx, w1, b1, w2, b2, ns, n_iters, lr, prox_mu)


def fed_compress_topk_q8(ef, k: int):
    """Top-k + int8 compression of the [K, P] error-feedback rows.
    Returns (q [K, P] int8, scale [K] f32)."""
    return fed_compress.fed_compress_topk_q8(ef, k)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Online-softmax attention with native GQA.  q: [B, S, Hq, hd];
    k/v: [B, T, Hkv, hd] -> out [B, S, Hq, hd] in q's dtype."""
    return fa.flash_attention_fwd(q, k, v, causal, window)[0]


def selective_scan(dt, A, Bmat, Cmat, x, h0):
    """Mamba-1 recurrence.  dt/x: [B, S, d]; A: [d, N]; Bmat/Cmat:
    [B, S, N]; h0: [B, d, N] -> (y [B, S, d] f32, hT [B, d, N] f32)."""
    return ss.selective_scan_fwd(dt, A, Bmat, Cmat, x, h0)


# the step families a fused local-SGD kernel exists for, by LocalStep.kind
FUSED_SGD_KINDS = ("mclr", "mlp")


def fused_sgd_eligible(step, sampling: str) -> bool:
    """A fused local-SGD kernel applies iff the step's ``kind`` is in
    ``FUSED_SGD_KINDS`` and minibatches follow the iid rule (indices drawn
    outside the kernel).  Every other step or sampling rule takes the
    engine's plain autodiff path; the cohort gather stays fused either way.
    """
    return (sampling == "iid"
            and getattr(step, "kind", None) in FUSED_SGD_KINDS)
