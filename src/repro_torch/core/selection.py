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
fewer than k clients are eligible).

The reference's sharded selection is ported as functions
(``local_topk_candidates``, ``merge_topk_candidates``, ``pad_scores``,
``select_cohort_sharded``): each shard's local top-k of its block, the
candidates all-gathered and re-ranked, bitwise the replicated cohort.
The port's sharded round does not call them: its scores are replicated
on every rank, so ``select_cohort_device`` there gives the same cohort
with no collective.  The capacity helpers at the end compact each shard's owned cohort slots
into a dense lane block, the reference's deterministic overflow policy.
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
    return _topk_ids(_cohort_scores(g, values, strategy, beta, use_al, elig),
                     k)


def _topk_ids(scores, k: int):
    """The indices of the k largest scores, lowest index first among
    equal scores (``lax.top_k``'s order)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


# ---------------------------------------------------------------------------
# sharded selection: local top-k per client shard, merged globally
# ---------------------------------------------------------------------------
#
# Shard s owns the contiguous score block [s*C, (s+1)*C).  Each shard takes
# a local top-min(k, C) of its block; the (score, global id) candidates are
# all-gathered; the winners are the top k of an [S*C] vector holding the
# candidates' scores at their global ids and -inf elsewhere.  Every shard
# forwards at least min(k, C) candidates, so the candidates hold the global
# top k, and the vector keeps global positions, so ties resolve at the
# replicated top-k's indices: the merged cohort is bitwise
# ``select_cohort_device``'s.


def local_topk_candidates(scores_pad, shard: int, clients_per_shard: int,
                          k: int):
    """Shard-local candidates: (scores [kk], global ids [kk] int64) with
    kk = min(k, C), from the [S*C] ghost-padded scores."""
    C = clients_per_shard
    block = torch.as_tensor(scores_pad)[shard * C:(shard + 1) * C]
    local = _topk_ids(block, min(k, C))
    return block[local], local + shard * C


def merge_topk_candidates(cand_scores, cand_ids, n_pad: int, k: int):
    """The global merge: scatter the candidates into an [n_pad] vector
    (-inf elsewhere; candidate ids are disjoint across shards) and take
    its top k (int64 [k])."""
    cand_scores = torch.as_tensor(cand_scores)
    sparse = torch.full((n_pad,), float("-inf"), dtype=torch.float32,
                        device=cand_scores.device)
    sparse = sparse.index_put(
        (torch.as_tensor(cand_ids).reshape(-1).long(),),
        cand_scores.reshape(-1).to(torch.float32))
    return _topk_ids(sparse, k)


def pad_scores(scores, n_shards: int):
    """Ghost-pad an [N] score vector to [S * ceil(N / S)] with -inf, so a
    ghost row (a client that does not exist) never wins a merge.  Returns
    (padded scores, C)."""
    scores = torch.as_tensor(scores).to(torch.float32)
    N = scores.shape[0]
    C = -(-N // n_shards)
    pad = torch.full((n_shards * C - N,), float("-inf"),
                     dtype=torch.float32, device=scores.device)
    return torch.cat([scores, pad]), C


def select_cohort_sharded(g, values, k: int, n_shards: int,
                          strategy: str = "random", beta: float = 0.01,
                          use_al=False, elig=None):
    """The mesh-free twin of the sharded selection: every shard's local
    top k, then the merge; the ids ``select_cohort_device`` returns, for
    any shard count."""
    scores, C = pad_scores(_cohort_scores(g, values, strategy, beta, use_al,
                                          elig), n_shards)
    cands = [local_topk_candidates(scores, s, C, k)
             for s in range(n_shards)]
    return merge_topk_candidates(torch.stack([v for v, _ in cands]),
                                 torch.stack([i for _, i in cands]),
                                 n_shards * C, k)


# ---------------------------------------------------------------------------
# capacity-compacted cohort execution
# ---------------------------------------------------------------------------
#
# The masked sharded round runs all K cohort slots on every shard with the
# non-owned budgets zeroed: sharding spreads the data, not the compute.
# With a capacity each shard packs its owned slots into a dense
# ``[capacity]`` lane block, runs only that, and scatters the results back
# to their [K] slots.  A shard that owns more than ``capacity`` slots keeps
# the first ``capacity`` in slot order; the rest overflow: such a client
# runs nothing this round and the server treats it as a dropped straggler
# (E~ = 0, the Ira/Fassa crash branch), counted in ``overflowed``.  Given
# the cohort, the same slots always overflow.

AUTO_CAPACITY_SLACK = 2   # "auto": ceil(K / S) * slack, capped at K


def resolve_capacity(spec, k: int, n_shards: int):
    """``ServerConfig.cohort_capacity`` -> a per-shard lane count or None.

    None / "full" -> None (the masked full-K round); "auto" -> ``min(K,
    AUTO_CAPACITY_SLACK * ceil(K / n_shards))``; an int is clamped to [1,
    K].  Any other spec requires sharding."""
    if spec is None or spec == "full":
        return None
    if not n_shards:
        raise ValueError(
            f"cohort_capacity={spec!r} requires mesh sharding "
            "(ServerConfig.mesh_shards >= 1); only 'full' runs replicated")
    if spec == "auto":
        return min(k, AUTO_CAPACITY_SLACK * (-(-k // n_shards)))
    cap = int(spec)
    if cap < 1:
        raise ValueError(f"cohort_capacity must be >= 1, got {cap}")
    return min(cap, k)


def cohort_shard_ranks(ids, clients_per_shard: int):
    """int64 [K]: how many earlier slots (j < k) the shard owning slot k
    (``ids[k] // C``) also owns."""
    ids = torch.as_tensor(ids).long()
    K = ids.shape[0]
    shard = ids // clients_per_shard
    same = shard[:, None] == shard[None, :]
    ar = torch.arange(K, device=ids.device)
    return (same & (ar[None, :] < ar[:, None])).sum(1)


def cohort_overflow(ids, clients_per_shard: int, capacity: int):
    """[K] bool: the slots the capacity policy drops (their shard already
    keeps ``capacity`` earlier slots).  The engine zeroes their budgets,
    the server sends them through the crash branch and counts them, all
    from this one mask."""
    return cohort_shard_ranks(ids, clients_per_shard) >= capacity


def compact_lane_map(ids, clients_per_shard: int, shard: int,
                     capacity: int):
    """int64 [capacity]: the cohort slot lane l of ``shard`` runs, or K
    (the unused-lane sentinel).  Lanes fill front to back in slot order,
    so scattering lane results to these slots (dropping K) rebuilds the
    shard's part of the [K] stack."""
    ids = torch.as_tensor(ids).long()
    K = ids.shape[0]
    own = (ids // clients_per_shard) == shard
    rank = torch.cumsum(own.long(), 0) - 1
    keep = own & (rank < capacity)
    lane = torch.where(keep, rank, capacity)
    out = torch.full((capacity + 1,), K, dtype=torch.int64,
                     device=ids.device)
    out = out.index_put((lane,), torch.arange(K, device=ids.device))
    return out[:capacity]


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
