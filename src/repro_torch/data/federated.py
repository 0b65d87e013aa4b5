"""Federated dataset generators and the packed device layout.

The generators are the port's own copy of the reference's numpy
generators (``repro/data/federated.py``): same draws from the same seeds,
so both packages train on bit-identical data.  They stand in for the LEAF
datasets, matching the paper's published statistics:

  MNIST-like     1,000 clients, 69,035 samples, 2 classes/client, power law
  FEMNIST-like     200 clients, 18,345 samples, 5 classes/client, 26 classes
  Synthetic(a,b)   100 clients, power law (the Shamir et al. generator)
  Sent140-like     772 clients, ~40,783 tweets, binary sentiment, token seqs

``FederatedDataset.packed`` uploads the whole federation to the device once
as a ``PackedClients`` of torch tensors; each round gathers its cohort
there.  ``packed(shards=S)`` builds the reference's sharded layout (client
blocks of ``C = ceil(N / S)``, ghost-padded) and ``PackedClients.shard``
moves one block to the device of the process that owns it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class PackedClients:
    """The flat federation on the device: every client's samples
    concatenated, addressed by per-client offset/length.

    ``x``/``y`` carry ``max_n`` zero rows of tail slack past the last
    client's samples, so every client's ``[offset, offset + max_n)`` window
    is in bounds (the contract the gather kernel copies against).

    Sharded layout (``packed(shards=S)``, the reference's): every array
    gains a leading shard axis.  Shard ``s`` owns the contiguous client
    block ``[s * C, (s + 1) * C)`` with ``C = clients_per_shard``, so
    global client ``g`` lives on shard ``g // C`` at local row ``g % C``.
    Each shard's flat arrays hold only its own clients' samples, with the
    same ``max_n`` tail slack, zero-padded to a common length; ``offsets``
    are shard-local.  The last shards may own ghost clients (``lengths ==
    0``) when S does not divide the population: they are never selected
    and gather nothing.  ``shard(rank, device)`` keeps one block (``rank``
    is then its index, -1 for a whole layout)."""
    x: torch.Tensor        # [total + max_n, ...feat]  (sharded: [S, L, ...])
    y: torch.Tensor        # [total + max_n] int32     (sharded: [S, L])
    offsets: torch.Tensor  # [n_clients] int32         (sharded: [S, C])
    lengths: torch.Tensor  # [n_clients] int32         (sharded: [S, C])
    max_n: int             # cohort shard width
    n_shards: int = 0            # 0 = the unsharded flat layout
    clients_per_shard: int = 0   # C (sharded layouts only)
    rank: int = -1               # the block a ``shard`` view holds

    def shard(self, rank: int, device: DeviceLike = None) -> "PackedClients":
        """Block ``rank`` of a sharded layout, moved to ``device``: x [L,
        ...], y [L], and the shard-local offsets and lengths [C].  The
        counterpart of the reference's ``shard_to``: each process holds
        only its own clients' samples."""
        if not self.n_shards or self.rank >= 0:
            raise ValueError("shard() requires a whole sharded layout "
                             "(FederatedDataset.packed(shards=S))")
        if not 0 <= rank < self.n_shards:
            raise ValueError(f"rank {rank} outside the layout's "
                             f"{self.n_shards} shards")
        dev = resolve_device(device)
        return dataclasses.replace(
            self, x=self.x[rank].to(dev), y=self.y[rank].to(dev),
            offsets=self.offsets[rank].to(dev),
            lengths=self.lengths[rank].to(dev), rank=int(rank))


@dataclasses.dataclass
class FederatedDataset:
    name: str
    clients_x: List[np.ndarray]
    clients_y: List[np.ndarray]
    test_x: np.ndarray
    test_y: np.ndarray
    n_classes: int
    task: str = "classification"   # classification | text

    @property
    def n_clients(self) -> int:
        return len(self.clients_x)

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(y) for y in self.clients_y])

    def stacked(self, client_ids, max_n: Optional[int] = None):
        """The selected clients in host-stacked padded numpy arrays, the
        seed round's input (``core.rounds.make_round_fn``): x [K, max_n,
        ...], y [K, max_n], mask [K, max_n], n [K]."""
        ids = list(client_ids)
        ns = np.array([len(self.clients_y[i]) for i in ids])
        m = int(max_n or ns.max())
        feat_shape = self.clients_x[ids[0]].shape[1:]
        x = np.zeros((len(ids), m) + feat_shape, self.clients_x[ids[0]].dtype)
        y = np.zeros((len(ids), m), np.int32)
        mask = np.zeros((len(ids), m), np.float32)
        for j, i in enumerate(ids):
            n = min(len(self.clients_y[i]), m)
            x[j, :n] = self.clients_x[i][:n]
            y[j, :n] = self.clients_y[i][:n]
            mask[j, :n] = 1.0
        return x, y, mask, np.minimum(ns, m)

    def packed(self, max_n: Optional[int] = None,
               device: DeviceLike = None,
               shards: Optional[int] = None) -> PackedClients:
        """One-time device upload of the whole federation.  ``max_n``
        bounds the per-round cohort shard width (default: the largest
        client).  ``shards`` selects the sharded layout (see
        ``PackedClients``), built on the host: ``shard`` then moves one
        block to its device."""
        ns = self.sizes
        m = int(max_n or ns.max())
        if shards:
            return self._packed_sharded(int(shards), m)
        dev = resolve_device(device)
        offsets = np.zeros(len(ns), np.int64)
        np.cumsum(ns[:-1], out=offsets[1:])
        pad_x = np.zeros((m,) + self.clients_x[0].shape[1:],
                         self.clients_x[0].dtype)
        x = np.concatenate(self.clients_x + [pad_x], axis=0)
        y = np.concatenate(self.clients_y + [np.zeros(m, np.int32)],
                           axis=0).astype(np.int32)
        return PackedClients(
            x=torch.from_numpy(x).to(dev), y=torch.from_numpy(y).to(dev),
            offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
            lengths=torch.from_numpy(ns.astype(np.int32)).to(dev),
            max_n=m)

    def _packed_sharded(self, shards: int, max_n: int) -> PackedClients:
        """The reference's ``_packed_sharded``: ``shards`` contiguous
        blocks of ``C = ceil(N / shards)`` clients (ghost-padded), each
        block's samples concatenated with ``max_n`` rows of tail slack, all
        blocks zero-padded to a common flat length."""
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        N = self.n_clients
        C = -(-N // shards)
        ns = self.sizes
        feat = self.clients_x[0].shape[1:]
        blocks = [list(range(s * C, min((s + 1) * C, N)))
                  for s in range(shards)]
        L = max((int(ns[b].sum()) if b else 0) for b in blocks) + max_n
        x = np.zeros((shards, L) + feat, self.clients_x[0].dtype)
        y = np.zeros((shards, L), np.int32)
        offsets = np.zeros((shards, C), np.int32)
        lengths = np.zeros((shards, C), np.int32)
        for s, block in enumerate(blocks):
            pos = 0
            for j, g in enumerate(block):
                n = len(self.clients_y[g])
                offsets[s, j] = pos
                lengths[s, j] = n
                x[s, pos:pos + n] = self.clients_x[g]
                y[s, pos:pos + n] = self.clients_y[g]
                pos += n
        return PackedClients(
            x=torch.from_numpy(x), y=torch.from_numpy(y),
            offsets=torch.from_numpy(offsets),
            lengths=torch.from_numpy(lengths), max_n=max_n,
            n_shards=shards, clients_per_shard=C)


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
        x = protos[y] + rng.normal(0, noise, (sizes[k], dim)).astype(np.float32)
        xs.append(x.astype(np.float32))
        ys.append(y)
    ty = rng.integers(0, n_classes, test_n).astype(np.int32)
    tx = protos[ty] + rng.normal(0, noise, (test_n, dim)).astype(np.float32)
    return xs, ys, tx, ty


def make_mnist_like(seed: int = 0, n_clients: int = 1000, total: int = 69035,
                    dim: int = 784, max_size: int = 400, sep: float = 1.0,
                    noise: float = 1.2) -> FederatedDataset:
    """Paper stats: 1,000 devices, 69,035 samples, 2 classes/device."""
    rng = np.random.default_rng(seed)
    xs, ys, tx, ty = _clustered_classification(
        rng, n_clients, total, n_classes=10, classes_per_client=2,
        dim=dim, sep=sep, noise=noise, max_size=max_size)
    return FederatedDataset("mnist", xs, ys, tx, ty, 10)


def make_femnist_like(seed: int = 0, n_clients: int = 200, total: int = 18345,
                      dim: int = 784, max_size: int = 400) -> FederatedDataset:
    """Paper stats: 200 devices, 18,345 samples, 5 classes/device, 26-class."""
    rng = np.random.default_rng(seed + 1)
    xs, ys, tx, ty = _clustered_classification(
        rng, n_clients, total, n_classes=26, classes_per_client=5,
        dim=dim, sep=0.8, noise=1.4, max_size=max_size)
    return FederatedDataset("femnist", xs, ys, tx, ty, 26)


def make_synthetic(alpha: float = 1.0, beta: float = 1.0, seed: int = 0,
                   n_clients: int = 100, dim: int = 60, n_classes: int = 10,
                   total: int = 75349, max_size: int = 2000) -> FederatedDataset:
    """Synthetic(alpha, beta) — the Shamir et al. generator (LEAF/FedProx).

    alpha controls how much local models differ; beta how much local data
    distributions differ.  Paper uses Synthetic(1,1), 100 devices.
    """
    rng = np.random.default_rng(seed + 2)
    sizes = power_law_sizes(rng, n_clients, total, max_size=max_size)
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)])
    xs, ys = [], []
    test_x, test_y = [], []
    for k in range(n_clients):
        u_k = rng.normal(0, alpha)
        b_k = rng.normal(0, beta)
        v_k = rng.normal(b_k, 1.0, dim)
        W = rng.normal(u_k, 1.0, (dim, n_classes))
        b = rng.normal(u_k, 1.0, n_classes)
        n = sizes[k] + 20
        x = rng.normal(v_k, 1.0, (n, dim)) * np.sqrt(diag)
        logits = x @ W + b
        y = np.argmax(logits, axis=-1).astype(np.int32)
        xs.append(x[:sizes[k]].astype(np.float32))
        ys.append(y[:sizes[k]])
        test_x.append(x[sizes[k]:].astype(np.float32))
        test_y.append(y[sizes[k]:])
    return FederatedDataset("synthetic(1,1)", xs, ys,
                            np.concatenate(test_x), np.concatenate(test_y),
                            n_classes)


def make_sent140_like(seed: int = 0, n_clients: int = 772, total: int = 40783,
                      vocab: int = 1000, seq_len: int = 25,
                      max_size: int = 300) -> FederatedDataset:
    """Binary sentiment over token sequences; 5 polarity tokens per tweet."""
    rng = np.random.default_rng(seed + 3)
    sizes = power_law_sizes(rng, n_clients, total, max_size=max_size)
    pos_tokens = np.arange(0, 100)
    neg_tokens = np.arange(100, 200)

    def tweets(n, labels):
        x = rng.integers(200, vocab, (n, seq_len)).astype(np.int32)
        n_sent = rng.integers(3, 8, n)
        for i in range(n):
            pool = pos_tokens if labels[i] == 1 else neg_tokens
            pos = rng.choice(seq_len, n_sent[i], replace=False)
            x[i, pos] = rng.choice(pool, n_sent[i])
        return x

    xs, ys = [], []
    for k in range(n_clients):
        y = rng.integers(0, 2, sizes[k]).astype(np.int32)
        xs.append(tweets(sizes[k], y))
        ys.append(y)
    ty = rng.integers(0, 2, 2000).astype(np.int32)
    tx = tweets(2000, ty)
    return FederatedDataset("sent140", xs, ys, tx, ty, 2, task="text")


DATASETS = {
    "mnist": make_mnist_like,
    "femnist": make_femnist_like,
    "synthetic": make_synthetic,
    "sent140": make_sent140_like,
}
