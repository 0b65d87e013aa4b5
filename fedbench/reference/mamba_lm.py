"""Plain reference of cross-silo FedSAE-Ira training a Mamba-1 language
model (Falcon-Mamba, arXiv:2410.05355; Mamba, arXiv:2312.00752), written
from the papers and the configuration, in plain PyTorch, float32.

The model: token embedding; ``n_layers`` residual blocks, each
``h + out_proj((scan(...) + D x) * silu(z))`` of the RMS-normed input
(``in_proj`` splits into x and the gate z; x through a causal depthwise
conv of width ``conv`` and silu; ``x_proj`` gives the step's low-rank dt,
B and C; dt = softplus(dt_lr dt_proj + dt_bias); A = -exp(A_log); the
selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = C_t . h_t);
a final RMS norm and an untied unembedding; the mean next-token
cross-entropy of the given labels.  Departures from the published model,
as the configuration states them: no RMS norms on B, C and dt, and labels
as the traffic gives them.

A silo's local step is plain SGD on every parameter; a round trains each
silo from the global model for its Ira budget and takes the FedAvg of the
silos that trained, weighted by their sizes.  The budgets follow Alg. 2
over the heterogeneity model's draws, scaled from epochs to local steps.

The scan runs in chunks: inside each chunk the recurrence is walked step
by step for all chunks at once, then the chunks' end states are carried
across, so a layer costs a few hundred launches.  Each layer is recomputed
in the backward pass (``torch.utils.checkpoint``), so the reference holds
one layer's activations at a time.

``precision`` rounds the operands of every projection (``in_proj``,
``x_proj``, ``dt_proj``, ``out_proj``, the unembedding) and the residual
stream between layers, the activations a bfloat16 program holds in its
compute type, as ``reference.precision`` does; the control runs it at
"fp8", the witness of bfloat16's own rounding at "bf16".  ``fault``
plants a fault for its reading: "half_batch" (the loss over the first half
of each row's tokens only) and "altered" (the first silo's trained
``out_proj`` of layer 0 and its reported loss changed where they are
produced).  A round that returns the model unchanged reads 1 by every
change compared, and needs no run.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from fedbench.reference.precision import exact_float32, matmul, operand

COMPLETED_H, COMPLETED_L, DROPPED = 2, 1, 0
FAULTS = ("", "half_batch", "altered")
MIXER = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
         "A_log", "D", "out_proj", "norm")


def rms_norm(x, gamma, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gamma


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def selective_scan(dt, A, Bm, Cm, x, chunk: int = 64):
    """dt, x [S, di]; A [di, N]; Bm, Cm [S, N] -> y [S, di] (h_0 = 0)."""
    S, di = x.shape
    N = A.shape[1]
    if S % chunk:
        chunk = S
    nc = S // chunk
    dA = (dt[:, :, None] * A[None]).view(nc, chunk, di, N)
    bx = ((dt * x)[:, :, None] * Bm[:, None, :]).view(nc, chunk, di, N)
    # whole steps and chunks through unbind: indexing one at a time would
    # give each its own full-size gradient in the backward pass
    h = torch.zeros((nc, di, N), dtype=x.dtype, device=x.device)
    local = []
    for a_t, b_t in zip(torch.exp(dA).unbind(1), bx.unbind(1)):
        h = a_t * h + b_t
        local.append(h)
    decay = torch.exp(torch.cumsum(dA, dim=1))           # prod of a to t
    carry = torch.zeros((di, N), dtype=x.dtype, device=x.device)
    entering = []
    for d_c, h_c in zip(decay[:, -1].unbind(0), h.unbind(0)):
        entering.append(carry)
        carry = d_c * carry + h_c
    h_all = torch.stack(local, 1) + decay * torch.stack(entering)[:, None]
    return torch.einsum("ctdn,ctn->ctd", h_all,
                        Cm.view(nc, chunk, N)).reshape(S, di)


class MambaLM:
    """The model's arithmetic over a params tree in the layout
    ``{"embeddings": {"tok", "unembed", "final_norm"}, "layers": [{...}]}``
    (one dict of the ``MIXER`` leaves a layer)."""

    def __init__(self, cfg: Dict, precision: str = "float32"):
        self.c = cfg
        self.precision = precision

    def _mm(self, a, b):
        return matmul(a, b, self.precision)

    def layer(self, h, p: Dict):
        c = self.c
        di, N, dtr = c["d_inner"], c["state"], c["dt_rank"]
        K = p["conv_w"].shape[0]
        xz = self._mm(rms_norm(h, p["norm"], c["eps"]), p["in_proj"])
        x, z = xz[:, :di], xz[:, di:]
        xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
        xc = sum(xp[i:i + x.shape[0]] * p["conv_w"][i] for i in range(K))
        xc = silu(xc + p["conv_b"])
        proj = self._mm(xc, p["x_proj"])
        dt_lr, Bm, Cm = proj[:, :dtr], proj[:, dtr:dtr + N], proj[:, dtr + N:]
        dt = softplus(self._mm(dt_lr, p["dt_proj"]) + p["dt_bias"])
        y = selective_scan(dt, -torch.exp(p["A_log"]), Bm, Cm, xc)
        y = y + p["D"] * xc
        return h + self._mm(y * silu(z), p["out_proj"])

    def loss(self, params, tokens, labels, half: bool = False):
        """Mean cross-entropy over the rows of ``tokens`` and ``labels``
        ([B, S]); with ``half`` over each row's first half only."""
        e = params["embeddings"]
        total = torch.zeros((), device=tokens.device)
        count = 0
        act = lambda x: operand(x, self.precision)   # noqa: E731
        for row, lab in zip(tokens, labels):
            h = act(e["tok"][row.long()])
            for p in params["layers"]:
                h = act(checkpoint(self.layer, h, p, use_reentrant=False))
            if half:
                h, lab = h[:h.shape[0] // 2], lab[:h.shape[0] // 2]
            hf = rms_norm(h, e["final_norm"], self.c["eps"])
            step = self.c["loss_chunk"]
            for s in range(0, hf.shape[0], step):
                logits = self._mm(hf[s:s + step], e["unembed"])
                gold = lab[s:s + step].long()[:, None]
                total = total + (torch.logsumexp(logits, -1)
                                 - logits.gather(-1, gold)[:, 0]).sum()
            count += hf.shape[0]
        return total / count


def leaves(params) -> List[torch.Tensor]:
    return (list(params["embeddings"].values())
            + [v for p in params["layers"] for v in p.values()])


def clone(params):
    return {"embeddings": {k: v.clone() for k, v in
                           params["embeddings"].items()},
            "layers": [{k: v.clone() for k, v in p.items()}
                       for p in params["layers"]]}


class SiloBudgets:
    """Ira over the silos' steps: the heterogeneity model's per-silo mu ~
    U[5, 10) and sigma ~ U[mu/4, mu/2) epochs from ``default_rng(seed)``,
    each round's draw from ``default_rng(seed + 1)``, mapped onto
    ``max_steps / 10`` steps an epoch and capped at ``max_steps``."""

    def __init__(self, K: int, seed: int, max_steps: int, U: float):
        rng = np.random.default_rng(seed)
        self.mu = rng.uniform(5.0, 10.0, K)
        self.sigma = rng.uniform(0.25 * self.mu, 0.5 * self.mu)
        self.rng = np.random.default_rng(seed + 1)
        self.max_steps, self.U = max_steps, U
        self.L, self.H = np.full(K, 1.0), np.full(K, 2.0)

    def next(self) -> np.ndarray:
        E = np.minimum(np.maximum(self.rng.normal(self.mu, self.sigma), 0.0)
                       * (self.max_steps / 10.0), self.max_steps)
        L, H, U = self.L, self.H, self.U
        out = np.where(E >= H, COMPLETED_H,
                       np.where(E >= L, COMPLETED_L, DROPPED))
        e_eff = np.where(out == COMPLETED_H, H,
                         np.where(out == COMPLETED_L, L, 0.0))
        gL, gH = L + U / np.maximum(L, 1e-6), H + U / np.maximum(H, 1e-6)
        L2 = np.where(out == COMPLETED_H, gL,
                      np.where(out == COMPLETED_L, np.minimum(gL, 0.5 * H),
                               0.5 * L))
        H2 = np.where(out == COMPLETED_H, gH,
                      np.where(out == COMPLETED_L, np.maximum(gL, 0.5 * H),
                               0.5 * H))
        L2 = np.maximum(L2, 0.25)
        H2 = np.maximum(H2, L2 + 1e-3)
        self.L = np.minimum(L2, self.max_steps)
        self.H = np.minimum(H2, self.max_steps)
        return np.round(e_eff).astype(np.int64)


class SiloReference:
    """The rounds: each silo's SGD steps from the global model, FedAvg."""

    def __init__(self, cfg: Dict, K: int, seed: int, sizes, lr: float,
                 max_steps: int, U: float, precision: str = "float32",
                 fault: str = ""):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; choose from {FAULTS}")
        self.model = MambaLM(cfg, precision)
        self.budgets = SiloBudgets(K, seed, max_steps, U)
        self.sizes = np.asarray(sizes, np.float32)
        self.lr, self.fault = lr, fault

    def _train(self, params, tokens, labels, steps: int) -> float:
        ps = leaves(params)
        total = 0.0
        for i in range(steps):
            for p in ps:
                p.requires_grad_(True)
            loss = self.model.loss(params, tokens[i], labels[i],
                                   half=self.fault == "half_batch")
            grads = torch.autograd.grad(loss, ps)
            with torch.no_grad():
                for p, g in zip(ps, grads):
                    p.requires_grad_(False)
                    p.sub_(g * self.lr)
            total += float(loss.detach())
            del loss, grads
        return total / max(steps, 1)

    def round(self, params, tokens, labels):
        """One round from ``params`` on [K, steps, B, S] tokens and labels:
        (new params, the silos' mean step losses [K], n_steps [K]).  The
        last silo that trains does so in ``params`` itself, which the
        round consumes, so a round holds two copies of the model."""
        n_steps = self.budgets.next()
        w = self.sizes * (n_steps > 0)
        tot = float(w.sum())
        losses = np.zeros(len(n_steps))
        ks = [k for k in range(len(n_steps)) if n_steps[k] > 0]
        acc = None
        with exact_float32():
            for i, k in enumerate(ks):
                p = params if i == len(ks) - 1 else clone(params)
                losses[k] = self._train(p, tokens[k], labels[k],
                                        int(n_steps[k]))
                if self.fault == "altered" and i == 0:
                    p["layers"][0]["out_proj"].view(-1)[0] += 0.01
                    losses[k] *= 1.01
                coef = float(w[k]) / tot
                with torch.no_grad():
                    if acc is None:
                        for a in leaves(p):
                            a.mul_(coef)
                        acc = p
                    else:
                        for a, b in zip(leaves(p), leaves(acc)):
                            b.add_(a, alpha=coef)
                del p
        return (params if acc is None else acc), losses, n_steps
