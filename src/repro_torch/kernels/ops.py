"""Public kernel ops of the port and the fused-SGD eligibility rule.

The three model ops are differentiable, as the reference's ``custom_vjp``s
(``repro/kernels/ops.py``) are, through ``torch.autograd.Function``s:

- ``flash_attention``: forward through the flash-attention forward
  (saving q, k, v, out and lse), backward through the flash-attention
  backward;
- ``selective_scan``: forward through the scan; backward by recomputing
  the plain ``ref.selective_scan`` under autograd, as the reference's
  ``_ss_bwd`` does (it has no backward kernel);
- ``fused_softmax_xent``: forward through the fused cross-entropy
  (saving h, W, labels and lse); on the bfloat16 tensor-core route (an odd
  vocabulary's too, where W comes ``pitched``) the backward runs the
  backward kernels from lse, and on every other route (the CPU, float32,
  bfloat16 that TMA cannot address) it recomputes the plain
  ``ref.softmax_xent`` on the chunk, as the reference's ``_fx_bwd`` does.

``pitched`` hands the cross-entropy its W: one cast copy into a
``[d, ceil8(V)]`` buffer, as its ``[:, :V]`` view, differentiable in the
source.

Every kernel call goes through ``roofline.costs.kernel``, which is the
plain call unless the dry-run's cost counter is active (then the call is
charged as one op, its bound's FLOPs and bytes) or the tensors are on the
meta device (then only the kernel's output shapes are made, nothing
runs).  On the meta device the cross-entropy backward takes the route the
card would take for the same dtypes and strides
(``fused_xent.tensor_core_route``), and the scan's backward charges its
plain recompute from traces of one, two and three steps
(``costs.extrapolated``).

The federated ops are forward-only: round functions are never
differentiated through (the local-SGD kernels compute their gradients in
closed form).  Every op goes to its wrapper, which runs the plain version
on a CPU tensor and the hand-written kernel on a CUDA tensor.  Each
federated op is a profiler range of its own (``obs.profiling.annotate``),
named as the reference's with the port's suffix: ``fed.gather.cuda``,
``fed.local_sgd.cuda``, ``fed.local_sgd_dense.cuda`` and
``fed.upload_transform.cuda``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (fed_compress, fed_gather, fed_local_sgd,
                                 flash_attention as fa, fused_xent, ref)
from repro_torch.kernels import fed_local_sgd_dense as dense_sgd
from repro_torch.kernels import selective_scan as ss
from repro_torch.obs.profiling import annotate
from repro_torch.roofline import costs


def _recompute_vjp(fn, inputs, grads):
    """Gradients of ``fn(*inputs)`` (a tensor or a tuple of tensors) with
    respect to ``inputs`` for the output cotangents ``grads`` (None for an
    output that received none), by running the plain ``fn`` again under
    autograd."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in inputs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [x for x in xs if x.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  wrt, [g for _, g in pairs],
                                  allow_unused=True)
    it = iter(got)
    return tuple(next(it) if x.requires_grad else None for x in xs)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = costs.kernel("flash_attention_fwd",
                                fa.flash_attention_fwd, q, k, v, causal,
                                window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = costs.kernel("flash_attention_bwd",
                                  fa.flash_attention_bwd, q, k, v, out, lse,
                                  g.contiguous(), ctx.causal, ctx.window)
        return dq, dk, dv, None, None


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, A, Bmat, Cmat, x, h0):
        ctx.save_for_backward(dt, A, Bmat, Cmat, x, h0)
        return costs.kernel("selective_scan_fwd", ss.selective_scan_fwd, dt,
                            A, Bmat, Cmat, x, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        if saved[0].device.type != "meta":
            return _recompute_vjp(ref.selective_scan, saved, (gy, gh))

        dt, A, Bmat, Cmat, x, h0 = saved

        def steps(s):       # the recompute over the first s steps
            _recompute_vjp(ref.selective_scan,
                           (dt[:, :s], A, Bmat[:, :s], Cmat[:, :s],
                            x[:, :s], h0), (gy[:, :s], gh))
        costs.extrapolated(steps, saved[0].shape[1])
        return tuple(torch.empty_like(t) for t in saved)


class _Pitched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, W, dtype):
        ctx.src_dtype = W.dtype
        return costs.kernel("pitched", fused_xent.pitched, W, dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.src_dtype), None


class _FusedSoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, labels):
        loss, lse = costs.kernel("fused_softmax_xent_fwd",
                                 fused_xent.fused_softmax_xent_fwd_lse, h, W,
                                 labels)
        ctx.save_for_backward(h, W, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, W, labels, lse = ctx.saved_tensors
        if fused_xent.tensor_core_route(h, W):
            dh, dW = costs.kernel("fused_softmax_xent_bwd",
                                  fused_xent.fused_softmax_xent_bwd, h, W,
                                  labels, lse, g.contiguous())
        else:
            dh, dW, _ = _recompute_vjp(ref.softmax_xent, (h, W, labels),
                                       (g,))
        return dh, dW, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Online-softmax attention with native GQA.  q: [B, S, Hq, hd];
    k/v: [B, T, Hkv, hd] -> out [B, S, Hq, hd] in q's dtype.
    Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, int(window))


def selective_scan(dt, A, Bmat, Cmat, x, h0):
    """Mamba-1 recurrence.  dt/x: [B, S, d]; A: [d, N]; Bmat/Cmat:
    [B, S, N]; h0: [B, d, N] -> (y [B, S, d] f32, hT [B, d, N] f32).
    Differentiable in every input."""
    return _SelectiveScan.apply(dt, A, Bmat, Cmat, x, h0)


def pitched(W, dtype):
    """W [d, V] cast to ``dtype`` into a ``[d, ceil8(V)]`` buffer with one
    ``copy_``, as its ``[:, :V]`` view (``fused_xent.pitched``): the rows
    of an odd vocabulary's W then start 16 bytes apart, as the
    cross-entropy's tensor-core kernels need.  Differentiable in W: the
    gradient of the view, cast back to W's dtype."""
    return _Pitched.apply(W, dtype)


def fused_softmax_xent(h, W, labels):
    """Per-row cross-entropy of ``h @ W`` without the [T, V] logits.
    h: [T, d]; W: [d, V]; labels: [T] int32 -> loss [T] f32.
    Differentiable in h and W."""
    return _FusedSoftmaxXent.apply(h, W, labels)


@annotate("fed.gather.cuda")
def fed_cohort_gather(flat_x, flat_y, starts, ns, max_n: int):
    """Fused gather + mask over the packed federation.  ``flat_x`` may have
    any feature shape; it is flattened to [rows, feat] for the kernel and
    the gathered x comes back as [K, max_n, ...feat].

    flat_x/flat_y must carry >= max_n rows of tail slack after the last
    client's samples (``FederatedDataset.packed`` pads at upload)."""
    feat_shape = tuple(flat_x.shape[1:])
    feat = math.prod(feat_shape)
    x, y, mask = costs.kernel(
        "fed_cohort_gather", fed_gather.fed_cohort_gather,
        flat_x.reshape(flat_x.shape[0], feat), flat_y, starts, ns, max_n)
    return x.reshape((x.shape[0], max_n) + feat_shape), y, mask


@annotate("fed.local_sgd.cuda")
def fed_local_sgd_mclr(x, y, idx, w0, b0, ns, n_iters, lr: float,
                       prox_mu: float = 0.0):
    """Fused masked budgeted MCLR local SGD.
    Returns (w_k [K, d, C], b_k [K, C], losses [K])."""
    return costs.kernel("fed_local_sgd_mclr",
                        fed_local_sgd.fed_local_sgd_mclr, x, y, idx, w0, b0,
                        ns, n_iters, lr, prox_mu)


@annotate("fed.local_sgd_dense.cuda")
def fed_local_sgd_dense(x, y, idx, w1, b1, w2, b2, ns, n_iters, lr: float,
                        prox_mu: float = 0.0):
    """Fused masked budgeted dense-MLP (tanh) local SGD.  Returns
    (w1_k [K, d, H], b1_k [K, H], w2_k [K, H, C], b2_k [K, C], losses [K])."""
    return costs.kernel("fed_local_sgd_dense", dense_sgd.fed_local_sgd_dense,
                        x, y, idx, w1, b1, w2, b2, ns, n_iters, lr, prox_mu)


@annotate("fed.upload_transform.cuda")
def fed_compress_topk_q8(ef, k: int):
    """Top-k + int8 compression of the [K, P] error-feedback rows.
    Returns (q [K, P] int8, scale [K] f32)."""
    return costs.kernel("fed_compress_topk_q8",
                        fed_compress.fed_compress_topk_q8, ef, k)


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
