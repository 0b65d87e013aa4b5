"""The benchmark's traffic generators, frozen so that the traffic cannot
move with the program.

``femnist_like`` is a copy of ``make_femnist_like`` (with
``power_law_sizes`` and ``_clustered_classification``) and
``silo_tokens`` a copy of ``silo_tokens`` from
``src/repro_torch/data/federated.py`` and
``src/repro_torch/launch/fl_train.py`` at commit
510ac229c19f024cd45ce40e03b24ade1eaa7a3e.  Both draw from numpy
generators seeded by the caller, so the same seed gives the same data.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Federation:
    """Every client's samples and the shared test set, as numpy arrays."""
    clients_x: List[np.ndarray]
    clients_y: List[np.ndarray]
    test_x: np.ndarray
    test_y: np.ndarray
    n_classes: int

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(y) for y in self.clients_y])


def power_law_sizes(rng: np.random.Generator, n_clients: int, total: int,
                    alpha: float = 1.6, min_size: int = 10,
                    max_size: int = 0) -> np.ndarray:
    """Per-client sample counts following a power law, summing ~= total."""
    raw = rng.pareto(alpha, n_clients) + 1.0
    sizes = raw / raw.sum() * (total - min_size * n_clients)
    sizes = (sizes + min_size).astype(int)
    if max_size:
        sizes = np.minimum(sizes, max_size)
    return np.maximum(sizes, min_size)


def _clustered_classification(rng, n_clients, total, n_classes,
                              classes_per_client, dim, sep, noise,
                              max_size=0, test_n=2000):
    """Gaussian class clusters in R^dim; label-skewed client partitions."""
    protos = rng.normal(0, sep, (n_classes, dim)).astype(np.float32)
    sizes = power_law_sizes(rng, n_clients, total, max_size=max_size)
    xs, ys = [], []
    for k in range(n_clients):
        classes = rng.choice(n_classes, classes_per_client, replace=False)
        y = rng.choice(classes, sizes[k]).astype(np.int32)
        x = protos[y] + rng.normal(0, noise, (sizes[k], dim)).astype(
            np.float32)
        xs.append(x.astype(np.float32))
        ys.append(y)
    ty = rng.integers(0, n_classes, test_n).astype(np.int32)
    tx = protos[ty] + rng.normal(0, noise, (test_n, dim)).astype(np.float32)
    return xs, ys, tx, ty


def femnist_like(seed: int = 0, n_clients: int = 200, total: int = 18345,
                 dim: int = 784, max_size: int = 400,
                 n_classes: int = 26, classes_per_client: int = 5
                 ) -> Federation:
    """The paper's FEMNIST statistics: 200 devices, 18,345 samples, 5
    classes a device out of 26."""
    rng = np.random.default_rng(seed + 1)
    xs, ys, tx, ty = _clustered_classification(
        rng, n_clients, total, n_classes=n_classes,
        classes_per_client=classes_per_client, dim=dim, sep=0.8, noise=1.4,
        max_size=max_size)
    return Federation(xs, ys, tx, ty, n_classes)


def silo_tokens(ri, vocab_size: int, K: int, max_steps: int, B: int = 2,
                S: int = 64):
    """One round's token stream: [K, max_steps, B, S] int32, silo k's
    tokens uniform in [0, vocab // (1 + k % 3)), so each silo has its own
    token distribution."""
    return np.stack([ri.integers(0, vocab_size // (1 + (k % 3)),
                                 (max_steps, B, S)) for k in range(K)]
                    ).astype(np.int32)
