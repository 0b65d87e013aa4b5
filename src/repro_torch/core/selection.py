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

The on-device Gumbel-top-k twins of the multi-round driver and capacity
compaction are ROADMAP item A12.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


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
