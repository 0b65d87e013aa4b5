"""Client selection strategies behind a registry: random (FedAvg),
Active-Learning softmax (paper Eqs. 6-7) and a loss-proportional variant
without the softmax.

AL: training value v_k = sqrt(n_k) * mean_loss_k (refreshed only for
participants); selection probability p_k = softmax(beta * v)_k; the server
samples K distinct participants ~ p (Gumbel top-k, without replacement).

These are the numpy functions of the reference's host driver, copied so
that equal numpy generators select equal cohorts.  Every strategy shares
the signature

    strategy(rng, values, n_clients, k, beta=0.01) -> ids [k]

The device drivers (``rng_impl="device"``, ``driver="scan"``) select on
the server's device instead, through the float32 Gumbel-top-k twins at
the end of this module: every strategy ranks ``logits + g`` for a Gumbel
draw ``g`` [N], and the top k are taken by a stable descending sort, so
equal scores resolve lowest index first as the reference's
``lax.top_k`` does (the -inf scores of quarantined clients tie whenever
fewer than k clients are eligible).  Capacity compaction (sharded
cohorts) is ROADMAP A12 (ii).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


class ValueTracker:
    def __init__(self, n_clients: int, sizes: np.ndarray,
                 init_loss: float = 2.0):
        self.v = np.sqrt(sizes) * init_loss
        self.sizes = sizes

    def update(self, client_ids, losses):
        """Eq. 6: refresh value only for this round's participants (a round
        with no participants leaves the values unchanged)."""
        ids = np.asarray(client_ids)
        if ids.size == 0:
            return
        self.v[ids] = np.sqrt(self.sizes[ids]) * np.asarray(losses)


def selection_probs(v: np.ndarray, beta: float = 0.01) -> np.ndarray:
    """Eq. 7 — beta-scaled softmax over training values."""
    z = beta * v
    z = z - z.max()
    p = np.exp(z)
    return p / p.sum()


def select_active(rng: np.random.Generator, v: np.ndarray, k: int,
                  beta: float = 0.01) -> np.ndarray:
    """Sample k distinct clients with probability proportional to Eq. 7
    (Gumbel top-k == PL sampling without replacement)."""
    p = selection_probs(v, beta)
    g = rng.gumbel(size=len(p))
    return np.argsort(-(np.log(np.maximum(p, 1e-12)) + g))[:k]


def select_random(rng: np.random.Generator, n_clients: int,
                  k: int) -> np.ndarray:
    return rng.choice(n_clients, size=k, replace=False)


def select_loss_proportional(rng: np.random.Generator, v: np.ndarray,
                             k: int) -> np.ndarray:
    """Sample k distinct clients with p_k proportional to the raw training
    value (no softmax; Gumbel top-k without replacement)."""
    v = np.asarray(v, np.float64)
    p = np.maximum(v, 1e-12)
    p = p / p.sum()
    g = rng.gumbel(size=len(p))
    return np.argsort(-(np.log(p) + g))[:k]


SelectionFn = Callable[..., np.ndarray]

SELECTIONS: Dict[str, SelectionFn] = {
    "random": lambda rng, v, n_clients, k, beta=0.01:
        select_random(rng, n_clients, k),
    "active": lambda rng, v, n_clients, k, beta=0.01:
        select_active(rng, v, k, beta),
    "loss_proportional": lambda rng, v, n_clients, k, beta=0.01:
        select_loss_proportional(rng, v, k),
}


def get_selection(name: str) -> SelectionFn:
    try:
        return SELECTIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown selection strategy {name!r}; "
            f"choose from {sorted(SELECTIONS)}") from None


# ---------------------------------------------------------------------------
# device twins: Gumbel-top-k sampling without replacement, float32
# ---------------------------------------------------------------------------
#
#   random             logits = 0            (uniform without replacement)
#   active             logits = beta * v     (softmax PL sampling: the
#                                             log-softmax shift cannot change
#                                             the top k)
#   loss_proportional  logits = log max(v, eps)

#: float32's smallest normal, the floor of the uniform a Gumbel draw reads
F32_TINY = float(np.finfo(np.float32).tiny)


def gumbel_noise(u):
    """Standard Gumbel draws ``-log(-log(u))`` from float32 uniforms in
    [0, 1), floored at the smallest normal as the reference's
    ``jax.random.gumbel`` floors its uniform."""
    return -torch.log(-torch.log(torch.clamp(u, min=F32_TINY)))


def _strategy_logits(strategy: str, v, beta: float):
    v = torch.as_tensor(v).to(torch.float32)
    if strategy == "random":
        return torch.zeros_like(v)
    if strategy == "active":
        return float(np.float32(beta)) * v
    if strategy == "loss_proportional":
        return torch.log(torch.clamp(v, min=float(np.float32(1e-12))))
    raise ValueError(
        f"unknown selection strategy {strategy!r}; "
        f"choose from {sorted(SELECTIONS)}")


def _cohort_scores(g, values, strategy: str, beta: float, use_al=False,
                   elig=None):
    """The perturbed scores every selection ranks: the strategy's logits
    (the active ones where ``use_al``, a Python or a 0-d device bool) plus
    the Gumbel draw ``g`` [N]; ineligible clients (``elig`` bool [N]
    False) score -inf."""
    v = torch.as_tensor(values).to(torch.float32)
    base = _strategy_logits(strategy, v, beta)
    if torch.is_tensor(use_al):
        base = torch.where(use_al, _strategy_logits("active", v, beta), base)
    elif use_al:
        base = _strategy_logits("active", v, beta)
    scores = base + torch.as_tensor(g).to(torch.float32)
    if elig is not None:
        scores = torch.where(elig, scores, float("-inf"))
    return scores


def select_cohort_device(g, values, k: int, strategy: str = "random",
                         beta: float = 0.01, use_al=False, elig=None):
    """k distinct clients (int64 [k]) by Gumbel top-k over ``g`` [N].
    ``use_al`` (a Python or a 0-d device bool) switches to the AL logits,
    so a block of rounds crosses the ``al_rounds`` boundary without a host
    decision; ``elig`` masks ineligible clients.  Ties resolve lowest
    index first (a stable descending sort)."""
    scores = _cohort_scores(g, values, strategy, beta, use_al, elig)
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def value_update_device(values, sizes, ids, losses, uploaded):
    """Twin of ``ValueTracker.update`` (Eq. 6) in float32: rows of ``ids``
    where ``uploaded`` is False keep their value (an all-crashed round is
    a no-op).  ``sizes`` are the [N] sample counts (any dtype)."""
    values = torch.as_tensor(values).to(torch.float32)
    ids = torch.as_tensor(ids).long()
    new_v = (torch.sqrt(torch.as_tensor(sizes).to(torch.float32)[ids])
             * torch.as_tensor(losses).to(torch.float32))
    return values.index_put((ids,), torch.where(
        torch.as_tensor(uploaded), new_v, values[ids]))
