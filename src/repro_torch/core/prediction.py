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

The float32 device twins of the multi-round driver are ROADMAP item A12.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

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
