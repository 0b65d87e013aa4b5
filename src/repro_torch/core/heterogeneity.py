"""Systems-heterogeneity simulator (paper §III-A / §IV-A).

Each client's per-round affordable workload (in local epochs) is drawn from
a client-specific Gaussian:  E~_k^t ~ N(mu_k, sigma_k^2)  with
mu_k ~ U[5, 10)  and  sigma_k ~ U[mu_k/4, mu_k/2).

The paper fixes the random seed so the same client has the same affordable
workload sequence across frameworks; this numpy copy of the reference's
host-driver simulator draws the same sequence from the same seed.

``pareto_slowdowns`` is the fault layer's heavy-tailed straggler draw
(``faults.inject``), the reference's formula on a float32 uniform from the
port's host fault stream.
"""
from __future__ import annotations

import numpy as np


def pareto_slowdowns(rng: np.random.Generator, alpha: float, shape):
    """Heavy-tailed per-client slowdown factors, float32, every one >= 1.

    Standard Pareto(alpha) by inverse CDF, ``(1 - u) ** (-1/alpha)`` for a
    float32 u ~ U[0, 1) drawn from ``rng``, as the reference computes it
    from a threefry uniform.  The fault layer divides the affordable
    workload by these factors, so a slowed client completes fewer local
    epochs and Ira/Fassa adapts to it like any other capability shift.
    """
    u = rng.random(shape, dtype=np.float32)
    return (np.float32(1.0) - u) ** np.float32(-1.0 / alpha)


class HeterogeneitySim:
    def __init__(self, n_clients: int, seed: int = 0,
                 mu_range=(5.0, 10.0), sigma_frac=(0.25, 0.5)):
        rng = np.random.default_rng(seed)
        self.mu = rng.uniform(*mu_range, n_clients)
        self.sigma = rng.uniform(sigma_frac[0] * self.mu,
                                 sigma_frac[1] * self.mu)
        self._rng = np.random.default_rng(seed + 1)
        self.n_clients = n_clients

    def sample_round(self) -> np.ndarray:
        """Affordable workload (epochs, float >= 0) for every client."""
        e = self._rng.normal(self.mu, self.sigma)
        return np.maximum(e, 0.0)
