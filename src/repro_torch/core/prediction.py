"""Affordable-workload prediction: FedSAE-Ira (Alg. 2) and FedSAE-Fassa
(Alg. 3) plus the task-pair semantics shared by both.

The numpy (float64) functions of the reference's host driver, copied so
that the port reproduces them bit for bit from the same inputs.  All are
vectorized over clients; the server calls them once per round for the
selected cohort.  Outcomes per Alg. 2/3:

  E~ >= H          -> client completes the hard task, uploads H-epoch weights
  L <= E~ < H      -> client drops mid-attempt; the L-epoch checkpoint is
                      uploaded ("partial work rescued")
  E~ < L           -> full drop-out, nothing uploaded

Note on Alg. 3 line 23: the paper prints ``min(L+r2, 1/2 L)`` which is
degenerate (always 1/2 L since r2 > 0); it is read as ``min(L+r2, 1/2 H)``
for consistency with Ira's partial-case rule (documented deviation).

The ``*_device`` functions are the float32 torch twins the device drivers
run (``rng_impl="device"`` and ``driver="scan"``), in the reference's
order of operations: every constant is a float32 value, every division
a tensor by a tensor (a division by a Python scalar may become a multiply
by its reciprocal), and the cohort's rows are scattered into the full [N]
history out of place (``index_put``; cohort ids are distinct, as the
reference relies on).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

COMPLETED_H = 2   # finished the difficult task
COMPLETED_L = 1   # finished only the easy task (uploads L-epoch weights)
DROPPED = 0       # uploaded nothing


def outcomes(L: np.ndarray, H: np.ndarray, E_true: np.ndarray) -> np.ndarray:
    """Per-client outcome code given the task pair and true workload."""
    return np.where(E_true >= H, COMPLETED_H,
                    np.where(E_true >= L, COMPLETED_L, DROPPED))


def uploaded_epochs(L: np.ndarray, H: np.ndarray,
                    E_true: np.ndarray) -> np.ndarray:
    """Epochs of training actually aggregated by the server (Ê_k^t)."""
    out = outcomes(L, H, E_true)
    return np.where(out == COMPLETED_H, H,
                    np.where(out == COMPLETED_L, L, 0.0))


# ---------------------------------------------------------------------------
# FedSAE-Ira: inverse-ratio arise (AIMD, Eq. 3)
# ---------------------------------------------------------------------------


def ira_predict(L: np.ndarray, H: np.ndarray, E_true: np.ndarray,
                U: float = 10.0, h_cap: float = 0.0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One step of Alg. 2.  Returns (L', H', outcome)."""
    L = np.asarray(L, np.float64)
    H = np.asarray(H, np.float64)
    out = outcomes(L, H, E_true)
    grow_L = L + U / np.maximum(L, 1e-6)
    grow_H = H + U / np.maximum(H, 1e-6)
    # success: additive (inverse-ratio) increase on both bounds
    L_s, H_s = grow_L, grow_H
    # partial: easy bound keeps growing but is capped at H/2; hard bound
    # relaxes toward the same point (min/max keeps L' <= H')
    L_p = np.minimum(grow_L, 0.5 * H)
    H_p = np.maximum(grow_L, 0.5 * H)
    # drop: multiplicative decrease
    L_d, H_d = 0.5 * L, 0.5 * H
    L_new = np.where(out == COMPLETED_H, L_s,
                     np.where(out == COMPLETED_L, L_p, L_d))
    H_new = np.where(out == COMPLETED_H, H_s,
                     np.where(out == COMPLETED_L, H_p, H_d))
    L_new = np.maximum(L_new, 0.25)
    H_new = np.maximum(H_new, L_new + 1e-3)
    if h_cap:
        L_new = np.minimum(L_new, h_cap)
        H_new = np.minimum(H_new, h_cap)
    return L_new, H_new, out


# ---------------------------------------------------------------------------
# FedSAE-Fassa: fast start / slow arise with an EMA threshold (Eqs. 4-5)
# ---------------------------------------------------------------------------


def fassa_threshold(theta: np.ndarray, E_true: np.ndarray,
                    alpha: float = 0.95) -> np.ndarray:
    """EMA of the realized affordable workload (Eq. 4)."""
    return alpha * theta + (1 - alpha) * E_true


def fassa_predict(L: np.ndarray, H: np.ndarray, E_true: np.ndarray,
                  theta: np.ndarray, gamma1: float = 3.0, gamma2: float = 1.0,
                  h_cap: float = 0.0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One step of Alg. 3.  Returns (L', H', outcome)."""
    L = np.asarray(L, np.float64)
    H = np.asarray(H, np.float64)
    out = outcomes(L, H, E_true)
    r1, r2 = gamma1, gamma2  # start-stage (fast) / arise-stage (slow)

    # success branch: stage per bound determined by where the EMA threshold
    # theta sits relative to the pair (three regimes):
    #   theta <= L      whole pair above the threshold -> both arise (r2)
    #   L < theta <= H  pair brackets the threshold    -> L start (r1),
    #                   H arise (r2)
    #   theta > H       pair fell below the threshold  -> L arise (r2),
    #                   H start (r1) to catch up
    L_s = np.where(theta <= L, L + r2,
                   np.where(theta <= H, L + r1, L + r2))
    H_s = np.where(theta <= L, H + r2,
                   np.where(theta <= H, H + r2, H + r1))

    # partial branch: grow the easy bound (stage-dependent), shrink toward H/2
    inc_p = np.where(theta <= L, r2, r1)
    L_p = np.minimum(L + inc_p, 0.5 * H)
    H_p = np.maximum(L + inc_p, 0.5 * H)

    # drop branch
    L_d, H_d = 0.5 * L, 0.5 * H

    L_new = np.where(out == COMPLETED_H, L_s,
                     np.where(out == COMPLETED_L, L_p, L_d))
    H_new = np.where(out == COMPLETED_H, H_s,
                     np.where(out == COMPLETED_L, H_p, H_d))
    L_new = np.maximum(L_new, 0.25)
    H_new = np.maximum(H_new, L_new + 1e-3)
    if h_cap:
        L_new = np.minimum(L_new, h_cap)
        H_new = np.minimum(H_new, h_cap)
    return L_new, H_new, out


# ---------------------------------------------------------------------------
# float32 device twins (torch) of the reference's ``*_device`` functions
# ---------------------------------------------------------------------------


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float: a scalar operand that
    a float32 op reads exactly."""
    return float(np.float32(x))


def _t32(x):
    return torch.as_tensor(x).to(torch.float32)


def outcomes_device(L, H, E_true):
    """Twin of :func:`outcomes` (int32 codes)."""
    L, H, E = _t32(L), _t32(H), _t32(E_true)
    return torch.where(E >= H, COMPLETED_H,
                       torch.where(E >= L, COMPLETED_L, DROPPED)
                       ).to(torch.int32)


def uploaded_epochs_device(L, H, E_true):
    """Twin of :func:`uploaded_epochs`."""
    L, H = _t32(L), _t32(H)
    out = outcomes_device(L, H, E_true)
    return torch.where(out == COMPLETED_H, H,
                       torch.where(out == COMPLETED_L, L, 0.0))


def _clamp_pair_device(L_new, H_new, h_cap):
    L_new = torch.clamp(L_new, min=0.25)
    H_new = torch.maximum(H_new, L_new + f32(1e-3))
    if h_cap:
        L_new = torch.clamp(L_new, max=f32(h_cap))
        H_new = torch.clamp(H_new, max=f32(h_cap))
    return L_new, H_new


def ira_predict_device(L, H, E_true, U: float = 10.0, h_cap: float = 0.0):
    """Twin of :func:`ira_predict` (float32)."""
    L, H = _t32(L), _t32(H)
    out = outcomes_device(L, H, E_true)
    grow_L = L + torch.full_like(L, f32(U)) / torch.clamp(L, min=f32(1e-6))
    grow_H = H + torch.full_like(H, f32(U)) / torch.clamp(H, min=f32(1e-6))
    L_p = torch.minimum(grow_L, 0.5 * H)
    H_p = torch.maximum(grow_L, 0.5 * H)
    L_new = torch.where(out == COMPLETED_H, grow_L,
                        torch.where(out == COMPLETED_L, L_p, 0.5 * L))
    H_new = torch.where(out == COMPLETED_H, grow_H,
                        torch.where(out == COMPLETED_L, H_p, 0.5 * H))
    L_new, H_new = _clamp_pair_device(L_new, H_new, h_cap)
    return L_new, H_new, out


def fassa_threshold_device(theta, E_true, alpha: float = 0.95):
    """Twin of :func:`fassa_threshold`: ``a * theta + (1 - a) * E`` with
    ``1 - a`` taken in float32."""
    theta, E = _t32(theta), _t32(E_true)
    a = np.float32(alpha)
    return float(a) * theta + float(np.float32(1.0) - a) * E


def fassa_predict_device(L, H, E_true, theta, gamma1: float = 3.0,
                         gamma2: float = 1.0, h_cap: float = 0.0):
    """Twin of :func:`fassa_predict` (float32)."""
    L, H, theta = _t32(L), _t32(H), _t32(theta)
    r1, r2 = f32(gamma1), f32(gamma2)
    out = outcomes_device(L, H, E_true)
    lo, mid = theta <= L, theta <= H
    L_s = torch.where(lo, L + r2, torch.where(mid, L + r1, L + r2))
    H_s = torch.where(lo, H + r2, torch.where(mid, H + r2, H + r1))
    inc_p = torch.where(lo, r2, r1)
    L_p = torch.minimum(L + inc_p, 0.5 * H)
    H_p = torch.maximum(L + inc_p, 0.5 * H)
    L_new = torch.where(out == COMPLETED_H, L_s,
                        torch.where(out == COMPLETED_L, L_p, 0.5 * L))
    H_new = torch.where(out == COMPLETED_H, H_s,
                        torch.where(out == COMPLETED_L, H_p, 0.5 * H))
    L_new, H_new = _clamp_pair_device(L_new, H_new, h_cap)
    return L_new, H_new, out


WORKLOAD_ALGOS = ("ira", "fassa", "fedavg", "fedprox", "oracle")


def workload_update_device(algo: str, L, H, theta, ids, E_true, *,
                           U: float = 10.0, alpha: float = 0.95,
                           gamma1: float = 3.0, gamma2: float = 1.0,
                           h_cap: float = 24.0, fixed_epochs: float = 15.0):
    """One server-side workload step over the full [N] history tensors:
    given the cohort ``ids`` [K] (distinct) and its true workloads
    ``E_true`` [K], returns

        (e_eff [K], outcome [K], assigned [K], L' [N], H' [N], theta' [N])

    with the cohort's rows of L/H/theta replaced (float32 throughout;
    the baselines return the history tensors themselves).  The device
    drivers' twin of ``FedSAEServer._workloads``."""
    L, H, theta = _t32(L), _t32(H), _t32(theta)
    E = _t32(E_true)
    if algo == "oracle":
        e_eff = torch.clamp(E, max=f32(h_cap))
        outcome = torch.where(e_eff > 0, COMPLETED_H, DROPPED).to(
            torch.int32)
        return e_eff, outcome, e_eff, L, H, theta
    if algo == "fedavg":
        ok = E >= f32(fixed_epochs)
        e_eff = torch.where(ok, f32(fixed_epochs), 0.0)
        outcome = torch.where(ok, COMPLETED_H, DROPPED).to(torch.int32)
        return e_eff, outcome, torch.full_like(E, f32(fixed_epochs)), \
            L, H, theta
    if algo == "fedprox":
        e_eff = torch.clamp(E, max=f32(fixed_epochs))
        outcome = torch.where(
            E >= f32(fixed_epochs), COMPLETED_H,
            torch.where(e_eff > 0, COMPLETED_L, DROPPED)).to(torch.int32)
        return e_eff, outcome, torch.full_like(E, f32(fixed_epochs)), \
            L, H, theta
    if algo not in ("ira", "fassa"):
        raise ValueError(
            f"unknown workload algo {algo!r}; choose from {WORKLOAD_ALGOS}")
    ids = torch.as_tensor(ids).long()
    Li, Hi = L[ids], H[ids]
    e_eff = uploaded_epochs_device(Li, Hi, E)
    if algo == "ira":
        L2, H2, outcome = ira_predict_device(Li, Hi, E, U=U, h_cap=h_cap)
    else:
        th_i = theta[ids]
        L2, H2, outcome = fassa_predict_device(Li, Hi, E, th_i, gamma1,
                                               gamma2, h_cap=h_cap)
        theta = theta.index_put((ids,), fassa_threshold_device(th_i, E,
                                                               alpha))
    return (e_eff, outcome, Hi, L.index_put((ids,), L2),
            H.index_put((ids,), H2), theta)
