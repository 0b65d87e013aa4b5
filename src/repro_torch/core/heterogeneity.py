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

The device drivers (``rng_impl="device"``, ``driver="scan"``) draw on the
server's device instead: ``device_params`` uploads the per-client (mu,
sigma) once as float32, and ``sample_workloads_device`` is the float32
twin of ``sample_round`` over a standard-normal draw ``z`` [N] from the
server's selection generator (or injected, ``FedSAEServer(device_draws=)``).
"""
from __future__ import annotations

import numpy as np
import torch


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


def sample_workloads_device(z, mu, sigma):
    """Affordable workloads for every client in float32 on the device:
    ``max(mu + sigma * z, 0)`` for a standard-normal draw ``z`` [N], as
    two rounded operations (the product, then the sum).  The twin of
    ``HeterogeneitySim.sample_round``: crash-heavy regimes (tiny mu)
    degenerate to all-zero workloads exactly as there."""
    return torch.clamp(mu + sigma * z, min=0.0)


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

    def device_params(self, device):
        """(mu, sigma) as float32 tensors on ``device``, uploaded once and
        read by ``sample_workloads_device`` every round."""
        return (torch.as_tensor(self.mu, dtype=torch.float32).to(device),
                torch.as_tensor(self.sigma, dtype=torch.float32).to(device))
