"""Plain reference of FedSAE-Ira rounds over MCLR clients (the paper's
Fig. 2 loop, arXiv:2104.07515 §III, with its §IV-A settings), written
from the paper and the configuration, in plain PyTorch.

One round, given the round's draws (standard normals ``z`` [N], Gumbel
noise ``g`` [N] and the data uniforms ``u``):

1. every client's affordable workload E = max(mu + sigma z, 0), with the
   paper's mu ~ U[5, 10) and sigma ~ U[mu/4, mu/2) per client, drawn from
   the seed as the heterogeneity model draws them;
2. the cohort: the K largest Gumbel scores (random selection), lowest index
   first among ties;
3. Ira (Alg. 2): a client that can afford its hard task H uploads H
   epochs, one that affords its easy task L uploads L, else nothing; the
   bounds then grow by U / bound, or split, or halve; L >= 1/4, H >= L +
   1e-3, both capped at h_cap;
4. each client's budget round(epochs * ceil(n / B)) SGD iterations, at
   most ``max_iters``;
5. local SGD on minibatches of B: drawn with replacement from ``u``
   (``iid``), or walked through one permutation of the client's samples
   sorted by ``u`` (``shuffle``);
6. FedAvg of the clients that trained, weighted by sample count;
7. the test-set loss and accuracy of the new global model.

Float32 throughout; the matrix products in the precision asked for
(``reference.precision``).  Nothing here reads the program.

``fault`` plants one of the faults a checked run has to catch, so that
their readings can be taken with the reference in the program's place:
"unchanged" (a round returns the global model as it was), "half_batch"
(each minibatch's second half left out, the mean taken over the rest) and
"altered" (the first client's trained weights and reported loss changed
where they are produced).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from fedbench.reference.precision import exact_float32, matmul

COMPLETED_H, COMPLETED_L, DROPPED = 2, 1, 0
FAULTS = ("", "unchanged", "half_batch", "altered")


def heterogeneity(n_clients: int, seed: int,
                  mu_range=(5.0, 10.0), sigma_frac=(0.25, 0.5)):
    """(mu, sigma) float64 [N]: mu ~ U[5, 10), sigma ~ U[mu/4, mu/2),
    from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(*mu_range, n_clients)
    sigma = rng.uniform(sigma_frac[0] * mu, sigma_frac[1] * mu)
    return mu, sigma


def max_iters_of(cfg: Dict, max_n: int) -> int:
    """The longest budget: the larger of h_cap and FedAvg's fixed epochs,
    times the largest client's batches an epoch."""
    budget = max(cfg["h_cap"], cfg["fixed_epochs"])
    return int(math.ceil(budget * math.ceil(max_n / cfg["batch_size"])))


def _f32(x):
    return float(np.float32(x))


class FedSAEReference:
    """The federation's server state (L, H) and its rounds."""

    def __init__(self, clients_x: List[np.ndarray],
                 clients_y: List[np.ndarray], test_x, test_y, n_classes: int,
                 cfg: Dict, seed: int, device, precision: str = "float32",
                 fault: str = ""):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; choose from {FAULTS}")
        self.dev = torch.device(device)
        self.cfg = cfg
        self.precision = precision
        self.fault = fault
        self.n_classes = n_classes
        self.x = [torch.as_tensor(x, device=self.dev) for x in clients_x]
        self.y = [torch.as_tensor(y, device=self.dev).long()
                  for y in clients_y]
        self.sizes = torch.as_tensor([len(y) for y in clients_y],
                                     device=self.dev)
        self.max_n = int(self.sizes.max())
        self.max_iters = max_iters_of(cfg, self.max_n)
        self.test_x = torch.as_tensor(test_x, device=self.dev)
        self.test_y = torch.as_tensor(test_y, device=self.dev).long()
        N = len(clients_y)
        mu, sigma = heterogeneity(N, seed)
        self.mu = torch.as_tensor(mu, dtype=torch.float32, device=self.dev)
        self.sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                     device=self.dev)
        lo, hi = cfg["init_pair"]
        self.L = torch.full((N,), float(lo), device=self.dev)
        self.H = torch.full((N,), float(hi), device=self.dev)

    # -- the server's algebra ---------------------------------------------
    def _ira(self, L, H, E):
        U, h_cap = self.cfg["U"], self.cfg["h_cap"]
        out = torch.where(E >= H, COMPLETED_H,
                          torch.where(E >= L, COMPLETED_L, DROPPED))
        e_eff = torch.where(out == COMPLETED_H, H,
                            torch.where(out == COMPLETED_L, L, 0.0))
        grow_L = L + torch.full_like(L, _f32(U)) / torch.clamp(L, min=_f32(
            1e-6))
        grow_H = H + torch.full_like(H, _f32(U)) / torch.clamp(H, min=_f32(
            1e-6))
        L_p = torch.minimum(grow_L, 0.5 * H)
        H_p = torch.maximum(grow_L, 0.5 * H)
        L2 = torch.where(out == COMPLETED_H, grow_L,
                         torch.where(out == COMPLETED_L, L_p, 0.5 * L))
        H2 = torch.where(out == COMPLETED_H, grow_H,
                         torch.where(out == COMPLETED_L, H_p, 0.5 * H))
        L2 = torch.clamp(L2, min=0.25)
        H2 = torch.maximum(H2, L2 + _f32(1e-3))
        L2 = torch.clamp(L2, max=_f32(h_cap))
        H2 = torch.clamp(H2, max=_f32(h_cap))
        return e_eff, L2, H2

    def plan(self, z, g):
        """(ids [K], n [K], n_iters [K]) of a round from its draws, and the
        Ira update of the cohort's bounds."""
        z = torch.as_tensor(z, device=self.dev)
        g = torch.as_tensor(g, device=self.dev)
        E_all = torch.clamp(self.mu + self.sigma * z, min=0.0)
        K = self.cfg["n_selected"]
        ids = torch.sort(g, descending=True, stable=True).indices[:K]
        e_eff, L2, H2 = self._ira(self.L[ids], self.H[ids], E_all[ids])
        self.L = self.L.index_put((ids,), L2)
        self.H = self.H.index_put((ids,), H2)
        B = self.cfg["batch_size"]
        n = torch.clamp(self.sizes[ids], max=self.max_n)
        tau = torch.ceil(n.to(torch.float32) / float(B))
        n_iters = torch.clamp(torch.round(e_eff * tau),
                              max=self.max_iters).long()
        return ids, n, n_iters

    # -- local training ---------------------------------------------------
    def _batches(self, ids, n, u):
        """Per client, the minibatch rows of every iteration: [K, iters,
        B] sample indices into the client's own samples."""
        B = self.cfg["batch_size"]
        nk = torch.clamp(n, min=1)
        if self.cfg["sampling"] == "iid":
            return torch.minimum((u * nk.view(-1, 1, 1)).long(),
                                 nk.view(-1, 1, 1) - 1)
        rows = []
        steps = self.max_iters * B
        for k in range(len(ids)):
            m = int(nk[k])
            perm = torch.sort(u[k, :m], stable=True).indices
            walk = torch.arange(steps, device=self.dev) % m
            rows.append(perm[walk].view(self.max_iters, B))
        return torch.stack(rows)

    def local_sgd(self, w0, b0, ids, n, n_iters, u):
        """Every client's SGD from the global (w0, b0): (w [K, d, C],
        b [K, C], reported losses [K])."""
        cfg, prec = self.cfg, self.precision
        B, lr, C = cfg["batch_size"], cfg["lr"], self.n_classes
        K = len(ids)
        u = torch.as_tensor(u, device=self.dev)
        idx = self._batches(ids, n, u)
        X = torch.stack([torch.nn.functional.pad(
            self.x[int(i)], (0, 0, 0, self.max_n - int(self.sizes[i])))
            for i in ids])                                   # [K, max_n, d]
        Y = torch.stack([torch.nn.functional.pad(
            self.y[int(i)], (0, self.max_n - int(self.sizes[i])))
            for i in ids])
        kk = torch.arange(K, device=self.dev)[:, None]
        bmask = (torch.arange(B, device=self.dev)[None, :]
                 < torch.clamp(n, min=1)[:, None]).to(torch.float32)
        if self.fault == "half_batch":
            bmask[:, B // 2:] = 0.0
        bsum = torch.clamp(bmask.sum(1), min=1.0)
        w = w0.expand((K,) + tuple(w0.shape)).clone()
        b = b0.expand((K,) + tuple(b0.shape)).clone()
        total = torch.zeros(K, device=self.dev)
        for i in range(int(n_iters.max()) if K else 0):
            rows = idx[:, i]
            xb, yb = X[kk, rows], Y[kk, rows]
            logp = torch.log_softmax(matmul(xb, w, prec) + b[:, None], -1)
            oy = torch.nn.functional.one_hot(yb, C).to(torch.float32)
            loss = (-(logp * oy).sum(-1) * bmask).sum(1) / bsum
            err = (torch.exp(logp) - oy) * (bmask / bsum[:, None])[..., None]
            gw = matmul(xb.transpose(1, 2), err, prec)
            active = (i < n_iters).to(torch.float32)
            w = w - lr * active[:, None, None] * gw
            b = b - lr * active[:, None] * err.sum(1)
            total = total + active * loss
        if cfg["sampling"] == "iid":
            losses = total / torch.clamp(n_iters.to(torch.float32), min=1.0)
        else:
            mask = (torch.arange(self.max_n, device=self.dev)[None, :]
                    < n[:, None]).to(torch.float32)
            losses = torch.stack([self._nll(X[k], Y[k], w[k], b[k], mask[k])
                                  for k in range(K)])
        if self.fault == "altered":
            w[0].view(-1)[0] += 0.01
            losses[0] *= 1.01
        return w, b, losses

    def _nll(self, x, y, w, b, mask=None):
        logp = torch.log_softmax(matmul(x, w, self.precision) + b, -1)
        nll = -torch.gather(logp, -1, y[:, None])[:, 0]
        if mask is None:
            return nll.mean()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    # -- one round --------------------------------------------------------
    @torch.no_grad()
    def round(self, params: Dict[str, torch.Tensor], draws: Dict):
        """One round from ``params`` ({"w", "b"}) and its draws ``z``,
        ``g``, ``u``.  Returns the round's record: ids, n_iters,
        train_loss, test_loss, acc and the new params."""
        with exact_float32():
            ids, n, n_iters = self.plan(draws["z"], draws["g"])
            w, b, losses = self.local_sgd(params["w"], params["b"], ids, n,
                                          n_iters, draws["u"])
            up = (n_iters > 0).to(torch.float32)
            weights = n.to(torch.float32) * up
            tot = weights.sum()
            if float(tot) > 0 and self.fault != "unchanged":
                coef = weights / tot
                new = {"w": (coef[:, None, None] * w).sum(0),
                       "b": (coef[:, None] * b).sum(0)}
            else:
                new = {k: v.clone() for k, v in params.items()}
            n_up = float(up.sum())
            train_loss = (float((losses * up).sum()) / n_up if n_up
                          else float("nan"))
            logits = matmul(self.test_x, new["w"], self.precision) + new["b"]
            test_loss = float(self._nll(self.test_x, self.test_y, new["w"],
                                        new["b"]))
            acc = float((logits.argmax(-1) == self.test_y).float().mean())
        return {"ids": ids.cpu().numpy(), "n_iters": n_iters.cpu().numpy(),
                "train_loss": train_loss, "test_loss": test_loss,
                "acc": acc, "params": new}
