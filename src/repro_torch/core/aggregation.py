"""Server-side aggregation for the port's round engine.

An aggregator is a callable

    aggregator(params_k, global_params, weights) -> new_global_params

where ``params_k`` is the client-params dict (nested for the LMs) with a
leading cohort axis K on every leaf, ``global_params`` the current global
dict and ``weights`` a ``[K]``
float32 vector (0 = the client uploaded nothing).  Everything stays on the
device: no aggregator reads a value back to the host, and none branches on
a tensor's value (counts, bands and selections stay device tensors).

The registry is the reference's (``repro/core/aggregation.py``):

  fedavg        size-weighted mean (McMahan et al.)
  fedprox       FedAvg mixing; carries the proximal weight ``prox_mu`` the
                engine adds to every local objective
  trimmed_mean  coordinate-wise trimmed mean over the uploading clients
  median        coordinate-wise median (the trim band on the middle)
  krum          (multi-)Krum: the upload(s) closest to their nearest
                neighbours in the full parameter space
  geometric_median
                Weiszfeld-iterated geometric median (RFA)
  bulyan        Krum-select the m - 2b most central uploads, then a
                coordinate-wise trimmed mean (b per end) over them

The robust aggregators treat ``weights`` as a validity mask unless
``weighted=True``, which weights only the surviving uploads by their n_k.
Invalid clients (weight 0) never enter a statistic.  None of them guards
against non-finite uploads: the engine's upload screen
(``faults.screen_uploads``, on whenever faults are configured) runs before
every one of them and hands a rejected row over as a crashed client's.

Every sort is stable, as ``jnp.sort``/``jnp.argsort`` are: equal values
keep their client order, so a weighted band carries the same n_k as the
reference's and Krum ranks its ``_FAR`` sentinels last in index order.

``_flatten_clients`` / ``_unflatten_like`` are the reference's one flatten
contract: leaves in ``jax.tree.leaves`` order, which for a params dict is
its SORTED keys (MLP: b1, b2, w1, w2; LSTM: b, b_out, emb, w_out, wh, wx),
never its insertion order.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


#: cuBLAS takes a product's dimensions below 2**31 - 1: a leaf of more
#: elements (Falcon-Mamba-7B's in_proj stacked over 32 layers has 2**31)
#: is mixed client by client, with no GEMM
GEMM_MAX = 2**31 - 1


def _mix(coef, stacked):
    """sum_k coef[k] * stacked[k]: one ``tensordot``, or for a leaf of
    ``GEMM_MAX`` elements or more, one ``addcmul_`` a client."""
    if stacked[0].numel() < GEMM_MAX:
        return torch.tensordot(coef, stacked, dims=1)
    out = stacked[0] * coef[0]
    for k in range(1, stacked.shape[0]):
        out.addcmul_(stacked[k], coef[k])
    return out


class FedAvg:
    """Size-weighted average; keeps the old global on an empty round."""

    name = "fedavg"
    prox_mu = 0.0

    def __call__(self, params_k, global_params, weights):
        tot = weights.sum()
        coef = torch.where(tot > 0, weights / torch.clamp(tot, min=1e-9),
                           torch.zeros_like(weights))

        def agg(stacked, g0):
            mixed = _mix(coef.to(torch.float32), stacked.to(torch.float32))
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


class TrimmedMean:
    """Coordinate-wise trimmed mean over clients with weight > 0.

    Per coordinate: sort the valid client values, drop ``floor(trim_ratio
    * m)`` from each end (m = number of valid uploads, the product taken
    in float32 as the reference's) and average the rest.  Invalid clients
    are pushed to +inf so they sort past rank m.  With no valid uploads the
    old global is kept.  ``trim_count`` overrides the ratio with a fixed
    per-end count, clamped so at least one rank survives (Bulyan's band).
    ``weighted=True`` averages the band by the clients' n_k; the band is
    still chosen by value rank."""

    name = "trimmed_mean"
    prox_mu = 0.0

    def __init__(self, trim_ratio: float = 0.1, weighted: bool = False,
                 trim_count: Optional[int] = None):
        if not 0.0 <= trim_ratio < 0.5:
            raise ValueError(f"trim_ratio must be in [0, 0.5), got "
                             f"{trim_ratio}")
        if trim_count is not None and trim_count < 0:
            raise ValueError(f"trim_count must be >= 0, got {trim_count}")
        self.trim_ratio = trim_ratio
        self.trim_count = trim_count
        self.weighted = bool(weighted)

    def _band(self, m):
        """(t, keep) for m valid uploads, all 0-d device tensors."""
        if self.trim_count is not None:
            t = torch.clamp(torch.clamp(m - 1, min=0) // 2,
                            max=int(self.trim_count))
        else:
            ratio = torch.full((), self.trim_ratio, dtype=torch.float32,
                               device=m.device)
            t = torch.floor(ratio * m.to(torch.float32)).to(m.dtype)
        return t, torch.clamp(m - 2 * t, min=1)

    def __call__(self, params_k, global_params, weights):
        valid = weights > 0
        m = valid.sum()
        K = weights.shape[0]
        t, keep = self._band(m)
        rank = torch.arange(K, device=weights.device)
        sel = (rank >= t) & (rank < m - t)

        def agg(stacked, g0):
            shape = (-1,) + (1,) * (stacked.dim() - 1)
            band = sel.reshape(shape)
            v = torch.where(valid.reshape(shape), stacked.to(torch.float32),
                            torch.inf)
            if self.weighted:
                # carry each client's n_k through the per-coordinate sort
                s, order = torch.sort(v, dim=0, stable=True)
                ws = torch.gather(
                    weights.to(torch.float32).reshape(shape).expand(v.shape),
                    0, order)
                ws = torch.where(band, ws, 0.0)
                s = torch.where(band, s, 0.0)
                mixed = (s * ws).sum(0) / torch.clamp(ws.sum(0), min=1e-9)
            else:
                s = torch.sort(v, dim=0, stable=True).values
                # zero trimmed/invalid ranks before summing (0 * inf = nan)
                s = torch.where(band, s, 0.0)
                mixed = s.sum(0) / keep.to(torch.float32)
            return torch.where(m > 0, mixed,
                               g0.to(torch.float32)).to(g0.dtype)

        return tree_map(agg, params_k, global_params)


class Median(TrimmedMean):
    """Coordinate-wise median: the trim band collapsed onto the middle
    element (odd m) or middle pair (even m).  ``weighted=True`` averages
    the middle pair by n_k (only the band mean is weighted)."""

    name = "median"

    def __init__(self, weighted: bool = False):
        super().__init__(0.0, weighted=weighted)

    def _band(self, m):
        t = torch.clamp(m - 1, min=0) // 2
        return t, torch.clamp(m - 2 * t, min=1)


# ---------------------------------------------------------------------------
# full-parameter-space robust aggregators (distances across the whole
# flattened update, not per coordinate)
# ---------------------------------------------------------------------------


def _flatten_clients(params_k):
    """Stacked client params tree [K, ...] -> [K, P] float32 matrix, leaves
    in sorted-key order."""
    leaves = tree_leaves(params_k)
    K = leaves[0].shape[0]
    return torch.cat([v.reshape(K, -1).to(torch.float32) for v in leaves],
                     dim=1)


def _unflatten_like(vec, global_params):
    """[..., P] float32 -> tree shaped/dtyped like ``global_params`` with
    ``vec``'s leading axes in front, read in sorted-key order."""
    lead, pos = tuple(vec.shape[:-1]), [0]

    def cut(leaf):
        start = pos[0]
        pos[0] += leaf.numel()
        return vec[..., start:pos[0]].reshape(
            lead + tuple(leaf.shape)).to(leaf.dtype)

    return tree_map(cut, global_params)


_FAR = 1e30   # sentinel distance for invalid clients (inf would 0*inf=nan)


def _krum_scores(flat, valid, n_byzantine: int):
    """Krum scores over the [K, P] upload matrix (Blanchard et al., 2017).

    Per valid client: the sum of squared distances to its ``m -
    n_byzantine - 2`` closest valid peers (the count clamped to [1, K-1]
    and capped at m-1, so a ``_FAR`` sentinel never enters a valid
    client's score).  Invalid clients score ``_FAR``.  Distances take the
    Gram form ``|x_i|^2 + |x_j|^2 - 2 x_i.x_j``, clamped at 0.  Returns
    (scores [K], m)."""
    K = flat.shape[0]
    m = valid.sum()
    sq = torch.sum(flat * flat, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * flat @ flat.T,
                     min=0.0)
    eye = torch.eye(K, dtype=torch.bool, device=flat.device)
    excluded = ~(valid[:, None] & valid[None, :]) | eye
    d2 = torch.where(excluded, _FAR, d2)
    c = torch.minimum(torch.clamp(m - n_byzantine - 2, min=1, max=K - 1),
                      torch.clamp(m - 1, min=0))
    nearest = torch.sort(d2, dim=1, stable=True).values
    rank = torch.arange(K, device=flat.device)
    scores = torch.where(rank[None, :] < c, nearest, 0.0).sum(1)
    return torch.where(valid, scores, _FAR), m


def _lowest(scores, q):
    """[K] float32 mask of the ``q`` lowest scores (a 0-d device tensor),
    ties broken by client index (a stable argsort)."""
    K = scores.shape[0]
    order = torch.argsort(scores, stable=True)      # invalid ranks last
    first = (torch.arange(K, device=scores.device) < q).to(torch.float32)
    return torch.zeros(K, dtype=torch.float32,
                       device=scores.device).scatter(0, order, first)


def _flat_global(global_params):
    """The global tree as a [P] float32 vector (sorted-key order)."""
    return _flatten_clients(tree_map(lambda g: g[None], global_params))[0]


class Krum:
    """(multi-)Krum (Blanchard et al., 2017): the ``multi`` valid uploads
    with the lowest :func:`_krum_scores` are averaged (``multi=1`` returns
    the single most central upload).  ``weighted=True`` averages the
    winners by their n_k; the selection stays distance-based.  With no
    valid uploads the old global is kept."""

    name = "krum"
    prox_mu = 0.0

    def __init__(self, n_byzantine: int = 0, multi: int = 1,
                 weighted: bool = False):
        if n_byzantine < 0:
            raise ValueError(f"n_byzantine must be >= 0, got {n_byzantine}")
        if multi < 1:
            raise ValueError(f"multi must be >= 1, got {multi}")
        self.n_byzantine = int(n_byzantine)
        self.multi = int(multi)
        self.weighted = bool(weighted)

    def _q(self, m):
        return torch.clamp(torch.clamp(m, min=1), max=self.multi)

    def select(self, flat, weights):
        """chosen [K] float32 0/1: the ``multi`` most central of the [K, P]
        uploads."""
        scores, m = _krum_scores(flat, weights > 0, self.n_byzantine)
        return _lowest(scores, self._q(m))

    def __call__(self, params_k, global_params, weights):
        flat = _flatten_clients(params_k)                       # [K, P]
        chosen = self.select(flat, weights)
        m = (weights > 0).sum()
        q = self._q(m)
        if self.weighted:
            cw = chosen * weights.to(torch.float32)
            mixed = (cw @ flat) / torch.clamp(cw.sum(), min=1e-9)
        else:
            mixed = (chosen @ flat) / q.to(torch.float32)
        return _unflatten_like(
            torch.where(m > 0, mixed, _flat_global(global_params)),
            global_params)


class GeometricMedian:
    """Geometric median by ``iters`` Weiszfeld steps (RFA, Pillutla et al.,
    2019), from the coordinate-wise median of the valid uploads; ``eps``
    guards the reciprocal when the iterate lands on an upload.  The step
    count is fixed (a Python loop, no convergence test on the device).
    ``weighted=True`` solves the n_k-weighted problem."""

    name = "geometric_median"
    prox_mu = 0.0

    def __init__(self, iters: int = 8, eps: float = 1e-8,
                 weighted: bool = False):
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        self.iters = int(iters)
        self.eps = float(eps)
        self.weighted = bool(weighted)

    def __call__(self, params_k, global_params, weights):
        valid = (weights > 0).to(torch.float32)
        m = valid.sum()
        wk = valid * weights.to(torch.float32) if self.weighted else valid
        flat = _flatten_clients(params_k)                       # [K, P]
        K = flat.shape[0]
        m_int = m.to(torch.int64)
        s = torch.sort(torch.where(valid[:, None] > 0, flat, _FAR), dim=0,
                       stable=True).values
        below = torch.clamp(m_int - 1, min=0)
        # the middle pair's ranks; clamped into [0, K-1] for an empty
        # round of one client, whose result the final where discards
        lo_at = torch.clamp(below // 2, max=K - 1).reshape(1)
        hi_at = torch.clamp(below - (m_int - 1) // 2, max=K - 1).reshape(1)
        y = 0.5 * (torch.index_select(s, 0, lo_at)[0]
                   + torch.index_select(s, 0, hi_at)[0])
        for _ in range(self.iters):
            d = torch.sqrt(torch.clamp(
                torch.sum((flat - y[None, :]) ** 2, dim=1),
                min=self.eps ** 2))
            w = wk / d
            y = (w @ flat) / torch.clamp(w.sum(), min=1e-12)
        return _unflatten_like(
            torch.where(m > 0, y, _flat_global(global_params)),
            global_params)


class Bulyan:
    """Bulyan-style composition (El Mhamdi et al., 2018): keep the ``q =
    clip(m - 2b, 1, m)`` valid uploads with the lowest Krum scores (b =
    ``n_byzantine``), then a coordinate-wise trimmed mean with b trimmed
    per end over them: the inner :class:`TrimmedMean` sees ``weights *
    selected``.  ``weighted=True`` weights the final band by n_k.  With no
    valid uploads the old global is kept."""

    name = "bulyan"
    prox_mu = 0.0

    def __init__(self, n_byzantine: int = 0, weighted: bool = False):
        if n_byzantine < 0:
            raise ValueError(f"n_byzantine must be >= 0, got {n_byzantine}")
        self.n_byzantine = int(n_byzantine)
        self.weighted = bool(weighted)
        self._inner = TrimmedMean(trim_count=self.n_byzantine,
                                  weighted=weighted)

    def select(self, flat, weights):
        """selected [K] float32 0/1 for the [K, P] uploads."""
        scores, m = _krum_scores(flat, weights > 0, self.n_byzantine)
        q = torch.minimum(torch.clamp(m - 2 * self.n_byzantine, min=1),
                          torch.clamp(m, min=1))
        return _lowest(scores, q)

    def __call__(self, params_k, global_params, weights):
        selected = self.select(_flatten_clients(params_k), weights)
        # m == 0 => q = 1 picks an invalid client, but its weight is 0, so
        # the inner trimmed mean sees no valid uploads and keeps the global
        return self._inner(params_k, global_params,
                           weights.to(torch.float32) * selected)


AGGREGATORS: Dict[str, type] = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "trimmed_mean": TrimmedMean,
    "median": Median,
    "krum": Krum,
    "geometric_median": GeometricMedian,
    "bulyan": Bulyan,
}


def get_aggregator(name: str, **kwargs) -> Callable:
    try:
        cls = AGGREGATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; choose from "
            f"{sorted(AGGREGATORS)}") from None
    return cls(**kwargs)
