"""Server-side aggregation for the port's round engine.

An aggregator is a callable

    aggregator(params_k, global_params, weights) -> new_global_params

where ``params_k`` is the client-params dict (nested for the LMs) with a
leading cohort axis K on every leaf, ``global_params`` the current global
dict and ``weights`` a ``[K]``
float32 vector (0 = the client uploaded nothing).  Everything stays on the
device: no aggregator reads a value back to the host.

This package ports ``fedavg`` and ``fedprox``.  The robust aggregators of
the reference's registry (trimmed_mean, median, krum, geometric_median,
bulyan) are ROADMAP item A6.

``_flatten_clients`` / ``_unflatten_like`` are the reference's one flatten
contract: leaves in ``jax.tree.leaves`` order, which for a params dict is
its SORTED keys (MLP: b1, b2, w1, w2), never its insertion order.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


class FedAvg:
    """Size-weighted average; keeps the old global on an empty round."""

    name = "fedavg"
    prox_mu = 0.0

    def __call__(self, params_k, global_params, weights):
        tot = weights.sum()
        coef = torch.where(tot > 0, weights / torch.clamp(tot, min=1e-9),
                           torch.zeros_like(weights))

        def agg(stacked, g0):
            mixed = torch.tensordot(coef.to(torch.float32),
                                    stacked.to(torch.float32), dims=1)
            return torch.where(tot > 0, mixed,
                               g0.to(torch.float32)).to(g0.dtype)

        def tree(pk, g):
            if isinstance(g, dict):
                return {k: tree(pk[k], g[k]) for k in g}
            return agg(pk, g)

        return tree(params_k, global_params)


class FedProx(FedAvg):
    """FedAvg mixing + a proximal term mu/2 * ||p - g||^2 in the local loss.
    The engine reads ``prox_mu`` off the aggregator."""

    name = "fedprox"

    def __init__(self, prox_mu: float = 0.1):
        if prox_mu < 0:
            raise ValueError(f"prox_mu must be >= 0, got {prox_mu}")
        self.prox_mu = float(prox_mu)


def _flatten_clients(params_k):
    """Stacked client params dict [K, ...] -> [K, P] float32 matrix, leaves
    in sorted-key order."""
    leaves = [params_k[name] for name in sorted(params_k)]
    K = leaves[0].shape[0]
    return torch.cat([v.reshape(K, -1).to(torch.float32) for v in leaves],
                     dim=1)


def _unflatten_like(vec, global_params):
    """[..., P] float32 -> dict shaped/dtyped like ``global_params`` with
    ``vec``'s leading axes in front, read in sorted-key order."""
    lead, out, pos = tuple(vec.shape[:-1]), {}, 0
    for name in sorted(global_params):
        leaf = global_params[name]
        out[name] = vec[..., pos:pos + leaf.numel()].reshape(
            lead + tuple(leaf.shape)).to(leaf.dtype)
        pos += leaf.numel()
    return out


AGGREGATORS: Dict[str, type] = {"fedavg": FedAvg, "fedprox": FedProx}
NOT_PORTED = ("trimmed_mean", "median", "krum", "geometric_median",
              "bulyan")


def get_aggregator(name: str, **kwargs) -> Callable:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"aggregator {name!r} is not ported yet (ROADMAP A6: rest of "
            "the aggregation registry)")
    try:
        cls = AGGREGATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; choose from "
            f"{sorted(AGGREGATORS) + list(NOT_PORTED)}") from None
    return cls(**kwargs)
