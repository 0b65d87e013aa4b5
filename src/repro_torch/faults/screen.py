"""Server-side defenses: the finite-upload screen and the reliability
quarantine, the port's counterpart of ``repro/faults/screen.py``.

``screen_uploads`` runs immediately before every registry aggregator (it
is called from ``RoundEngine._finish``, the one aggregation entry of the
packed and the cross-silo rounds).  A screened-out row is demoted to the
existing zero-budget crash branch:

  * its aggregation weight becomes 0 (so FedAvg/FedProx never mix it), and
  * its row value is replaced by the current global params, the exact
    stack value a crashed (zero-budget) client produces, because several
    aggregators are poisoned by the mere presence of a non-finite row even
    at weight zero (FedAvg's weighted sum: 0 * NaN = NaN; geometric-median
    and Krum distances: a NaN row infects every pairwise distance).

After screening, the (stack, weights) pair entering the aggregator is
bitwise the pair of the run where the faulty client simply crashed, so
the global params cannot be contaminated, and an all-faulty round
degenerates to the existing no-participant no-op (every weight 0).

The screen holds at most ``SCREEN_CHUNK_BYTES`` of a leaf's rows in
temporaries at a time (one row of a full-width LM leaf, a whole leaf of an
FL model) and sanitizes in place, copying the global params into the
rejected rows only, so a full-width silo stack is screened without a
second copy.  That needs the [K] verdict on the host: one read a round.

``screen_uploads_device`` is the form of the device drivers
(``rng_impl="device"``, ``driver="scan"``), which may not read the host
between two stats pulls: the same verdicts, ``bad`` kept on the device,
and each rejected row replaced by the global row through ``torch.where``
over the whole [K, ...] stack (a new stack; at most ~57k coordinates a
row on the FL paths).

``quarantine_update`` and ``eligibility`` are the reliability layer on
top: per-client attempted / screened-failure counters; a client whose
failure rate crosses the threshold is suspended from selection for
``quarantine_rounds`` rounds (its counters reset on trip, so it re-earns
trust after the suspension).  They are pure torch functions of a round
index ``t`` that may be a Python int or a 0-d device tensor; the device
drivers call them (quarantine masks the device Gumbel-top-k).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

#: the most bytes of a leaf's rows the screen reads in one piece
SCREEN_CHUNK_BYTES = 256 * 2 ** 20


def screen_uploads(global_params, params_k, weights, norm_bound: float):
    """Finite + norm screen over a stacked upload.

    global_params  unstacked dict (current global params)
    params_k       dict of [K, ...] stacked uploads (post upload
                   transform: what would enter the aggregator); its
                   rejected rows are overwritten IN PLACE with the global
                   params
    weights        f32 [K] aggregation weights (0 already means "not
                   uploading"; only weight > 0 rows are screened)
    norm_bound     reject rows whose full-row delta l2 norm exceeds this

    Returns ``(params_k, weights_clean, bad)``: the sanitized stack (the
    same tensors), the weights with the rejected rows at 0, and ``bad``,
    the bool [K] mask of rejected rows, read to the host (a CPU tensor).

    A row is non-finite iff its sum of squared deltas is NaN (a NaN
    entry) or its largest |delta| is infinite; a finite row's sum of
    squares is compared with ``norm_bound ** 2`` in float32, as the
    reference's masked sum is.
    """
    leaves_k = tree_leaves(params_k)
    leaves_g = tree_leaves(global_params)
    K = weights.shape[0]
    dev = weights.device
    amax = torch.zeros((K,), dtype=torch.float32, device=dev)
    sq = torch.zeros((K,), dtype=torch.float32, device=dev)
    for p, g in zip(leaves_k, leaves_g):
        row_bytes = max(1, p[0].numel() * 4) if K else 1   # as float32
        step = max(1, SCREEN_CHUNK_BYTES // row_bytes)
        for a in range(0, K, step):
            part = slice(a, a + step)
            d = (p[part] - g).reshape(min(step, K - a), -1).to(
                torch.float32)
            torch.maximum(amax[part], torch.linalg.vector_norm(
                d, ord=float("inf"), dim=1), out=amax[part])
            sq[part] += torch.sum(d.square_(), dim=1)
            del d
    bad = _row_verdicts(amax, sq, weights, norm_bound)
    bad_host = bad.cpu()                      # the screen's one host read
    rows = [k for k, b in enumerate(bad_host.tolist()) if b]
    with torch.no_grad():
        for p, g in zip(leaves_k, leaves_g):
            for k in rows:
                p[k].copy_(g)
    return params_k, torch.where(bad, torch.zeros_like(weights),
                                 weights), bad_host


def _row_verdicts(amax, sq, weights, norm_bound: float):
    """bool [K]: uploading rows (weight > 0) that are non-finite (sum of
    squares NaN or inf-norm infinite) or whose float32 sum of squared
    deltas exceeds ``norm_bound ** 2``."""
    bound_sq = float(np.float32(norm_bound) ** np.float32(2))
    return (weights > 0) & (torch.isnan(sq) | torch.isinf(amax)
                            | (sq > bound_sq))


def screen_uploads_device(global_params, params_k, weights,
                          norm_bound: float):
    """``screen_uploads`` without a host read.  Returns ``(params_k_clean,
    weights_clean, bad)``: a new stack whose rejected rows hold the global
    params, the weights with those rows at 0, and ``bad`` [K] bool on the
    device.  The verdicts are ``screen_uploads``'s."""
    leaves_k = tree_leaves(params_k)
    leaves_g = tree_leaves(global_params)
    K = weights.shape[0]
    amax = torch.zeros((K,), dtype=torch.float32, device=weights.device)
    sq = torch.zeros((K,), dtype=torch.float32, device=weights.device)
    for p, g in zip(leaves_k, leaves_g):
        d = (p - g).reshape(K, -1).to(torch.float32)
        amax = torch.maximum(amax, torch.linalg.vector_norm(
            d, ord=float("inf"), dim=1))
        sq = sq + torch.sum(d.square_(), dim=1)
    bad = _row_verdicts(amax, sq, weights, norm_bound)

    def clean(p, g):
        m = bad.reshape((-1,) + (1,) * (p.dim() - 1))
        return torch.where(m, g.expand_as(p), p)

    return (tree_map(clean, params_k, global_params),
            torch.where(bad, torch.zeros_like(weights), weights), bad)


def quarantine_update(fail, tries, susp_until, ids, attempted, failed, t,
                      threshold: float, quarantine_rounds: int,
                      min_tries: int):
    """One round of reliability bookkeeping (pure: new tensors out).

    fail, tries   int32 [N] screened-failure / attempted-upload counters
    susp_until    int32 [N] first round at which the client is eligible
                  again (0 = never suspended)
    ids           int [K] selected clients (unique within a round)
    attempted     bool [K] rows that delivered an upload to the screen
    failed        bool [K] rows the screen rejected
    t             current round index (an int or a 0-d device tensor)

    A client trips when it has at least ``min_tries`` attempts on record
    and its failure rate exceeds ``threshold``; tripping suspends it until
    round ``t + 1 + quarantine_rounds`` and resets both counters.
    Returns ``(fail, tries, susp_until, n_suspended)`` where n_suspended
    (an int32 scalar tensor) counts clients serving a suspension after
    this update.
    """
    i32 = torch.int32
    ids = ids.long()
    tries = tries.index_add(0, ids, attempted.to(i32))
    fail = fail.index_add(0, ids, failed.to(i32))
    trip = ((tries >= min_tries)
            & (fail.to(torch.float32)
               > float(np.float32(threshold)) * tries.to(torch.float32)))
    until = (t + (1 + int(quarantine_rounds))).to(i32) if torch.is_tensor(t) \
        else int(t) + 1 + int(quarantine_rounds)
    susp_until = torch.where(trip, until, susp_until)
    tries = torch.where(trip, 0, tries)
    fail = torch.where(trip, 0, fail)
    n_susp = (susp_until > t).sum(dtype=i32)
    return fail, tries, susp_until, n_susp


def eligibility(susp_until, t):
    """bool [N]: clients not currently suspended (selectable at round t)."""
    return susp_until <= t
