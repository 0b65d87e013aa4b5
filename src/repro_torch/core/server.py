"""FedSAE server on the host driver: the training loop of the paper's Fig. 2.

Per round the server (1) draws every client's affordable workload and
selects a cohort (AL during the first ``al_rounds``, then the configured
strategy), (2) predicts each participant's task pair with Ira/Fassa (or
applies a baseline's fixed workload), (3) runs the packed round on the
device — gather, masked budgeted local SGD, the optional upload transform,
aggregation — and (4) updates
the history and the training values from the uploaded losses.  Baselines:
FedAvg (fixed workload, stragglers upload nothing), FedProx (ideal partial
work) and an oracle skyline.

Everything but step (3) is numpy float64 on the host, copied from the
reference's ``rng_impl="numpy"`` host driver, so the port reproduces
selection, workloads, budgets and L/H/theta bit for bit from the same
seeds.  Only the model init and the minibatch draws come from torch
generators; ``init_params=`` and ``data_draws=`` replace them so a test can
replay the reference's threefry draws.

With ``upload_compress="topk_q8"`` every uploading client's delta is
top-k sparsified and int8 quantised with error feedback
(``core.compression``); the server keeps the [N, P] float32 residual on
its device and replaces it with each round's output.

``ServerConfig`` has every field of the reference's, each at the
reference's default.  ``backend`` takes "xla" and "pallas" and both run the
same code: the port dispatches by device (the hand-written kernels on a
CUDA tensor, their plain versions on a CPU one), not by backend.  Not
ported yet, and refused with a ValueError naming the ROADMAP item when set
to anything but the default: the robust aggregators and their knobs (A6),
fault injection, the upload screen and quarantine (A9), telemetry sinks
(``FedSAEServer(sink=, telemetry=)``, A10), checkpoints
(``run(checkpoint_dir=, checkpoint_every=, resume=)``, A11), the scan
driver, device rng streams, mesh sharding, capacity compaction, prefetch
and the fused generic walk (A12), and the grouped sub-configs
``compute=``, ``comm=`` and ``robustness=`` (A15).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_reference
from repro_torch.core import compression as comp
from repro_torch.core import prediction as pred
from repro_torch.core.aggregation import NOT_PORTED as ROBUST_AGGREGATORS
from repro_torch.core.aggregation import get_aggregator
from repro_torch.core.engine import RoundEngine
from repro_torch.core.heterogeneity import HeterogeneitySim
from repro_torch.core.rounds import make_eval_fn
from repro_torch.core.selection import (ValueTracker, get_selection,
                                        select_active)
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.models.fl_models import resolve_local_step

ALGOS = ("ira", "fassa", "fedavg", "fedprox", "oracle")

#: scalar per-round metrics, in the reference's history order
#: (repro/obs/schema.py HISTORY_KEYS)
HISTORY_KEYS = ("acc", "test_loss", "train_loss", "dropout", "assigned",
                "uploaded", "true_workload", "overflowed", "dropped")

_A6 = "A6 (rest of the aggregation registry)"
_A9 = "A9 (faults + screen + quarantine)"
_A12 = "A12 (device-resident multi-round driver)"

#: un-ported ServerConfig features: field -> (default, ROADMAP item)
_NOT_PORTED = {
    "trim_ratio": (0.1, _A6),
    "agg_weighted": (False, _A6),
    "n_byzantine": (0, _A6),
    "driver": ("host", _A12),
    "block_size": (16, _A12),
    "mesh_shards": (0, "A12 (client-axis sharding)"),
    "cohort_capacity": ("full", "A12 (capacity compaction)"),
    "prefetch": ("off", "A12 (double-buffered prefetch)"),
    "fused_generic": (True, _A12),
    "faults": (None, _A9),
    "screen_norm_bound": (1e4, _A9),
    "quarantine_threshold": (0.0, _A9),
    "quarantine_rounds": (16, _A9),
    "quarantine_min_tries": (3, _A9),
    "compute": (None, "A15 (grouped config surface)"),
    "comm": (None, "A15 (grouped config surface)"),
    "robustness": (None, "A15 (grouped config surface)"),
}
#: values the port accepts for fields whose other values are not ported
_ACCEPTED = {
    "rng_impl": (("", "numpy"), "A12 (device rng streams)"),
    "upload_screen": (("auto", "off"), _A9),
}
BACKENDS = ("xla", "pallas")


def _refuse(what: str, item: str):
    """The ValueError every unported option raises: it names the option
    and its ROADMAP item."""
    return ValueError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass
class ServerConfig:
    algo: str = "ira"            # ira | fassa | fedavg | fedprox | oracle
    n_selected: int = 10         # K
    lr: float = 0.03
    batch_size: int = 10
    rounds: int = 100
    fixed_epochs: float = 15.0   # FedAvg/FedProx assigned workload E
    h_cap: float = 24.0          # cap on predicted H (bounds the budget)
    init_pair: tuple = (1.0, 2.0)
    U: float = 10.0              # Ira inverse-ratio increment
    alpha: float = 0.95          # Fassa EMA smoothing
    gamma1: float = 3.0
    gamma2: float = 1.0
    al_rounds: int = 0           # use AL selection for the first n rounds
    beta: float = 0.01           # AL softmax scale
    prox_mu: float = 0.1         # FedProx proximal weight
    aggregator: str = "fedavg"   # fedavg | fedprox (the robust ones: A6)
    selection: str = "random"    # post-AL strategy (core.selection)
    sampling: str = "shuffle"    # shuffle (paper default) | iid (fused
                                 # MCLR / MLP local-SGD kernels)
    backend: str = "xla"         # xla | pallas: the same code either way
                                 # (kernels on a CUDA device, their plain
                                 # versions on the CPU)
    seed: int = 0
    selection_seed: int = 1234   # fixed across frameworks (paper §IV-A)
    eval_every: int = 1
    model: object = None         # None | "mclr" | "mlp" | a LocalStep
    upload_compress: str = "none"  # none | topk_q8 (top-k + int8 with
                                   # error feedback: core.compression)
    topk_frac: float = 0.1       # kept-coordinate fraction for "topk_q8"
    device: Optional[str] = None  # None = cuda; "cpu" on request
    # reference features not ported yet (must stay at their defaults)
    trim_ratio: float = 0.1
    agg_weighted: bool = False
    n_byzantine: int = 0
    driver: str = "host"
    block_size: int = 16
    rng_impl: str = ""           # "" | numpy (the host driver's streams)
    mesh_shards: int = 0
    cohort_capacity: object = "full"
    prefetch: str = "off"
    fused_generic: bool = True
    faults: object = None
    upload_screen: str = "auto"  # auto | off ("on" is ROADMAP A9)
    screen_norm_bound: float = 1e4
    quarantine_threshold: float = 0.0
    quarantine_rounds: int = 16
    quarantine_min_tries: int = 3
    compute: object = None
    comm: object = None
    robustness: object = None

    def __post_init__(self):
        for name, (default, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            if value is not default and value != default:
                raise _refuse(f"ServerConfig.{name}={value!r}", item)
        for name, (ok, item) in _ACCEPTED.items():
            value = getattr(self, name)
            if value not in ok:
                raise _refuse(f"ServerConfig.{name}={value!r}", item)
        if self.aggregator in ROBUST_AGGREGATORS:
            raise _refuse(f"ServerConfig.aggregator={self.aggregator!r}", _A6)
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; choose "
                             f"from {BACKENDS}")
        if self.algo not in ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}; choose from "
                             f"{ALGOS}")


class FedSAEServer:
    """The FedSAE training loop on the host driver.

    ``init_params`` (a dict of numpy arrays, e.g. the reference's init)
    replaces the torch init.  ``data_draws(t, ids, n)``, given round t's
    numpy cohort and sample counts, returns that round's minibatch draws
    (idx [K, max_iters, B] for iid, u [K, max_n] for shuffle) in place of
    the device generator's."""

    def __init__(self, dataset: FederatedDataset, model=None,
                 cfg: Optional[ServerConfig] = None,
                 het: Optional[HeterogeneitySim] = None,
                 init_params=None,
                 data_draws: Optional[Callable] = None,
                 sink=None, telemetry: Optional[bool] = None):
        if sink is not None or telemetry is not None:
            raise _refuse(f"FedSAEServer(sink={sink!r}, "
                         f"telemetry={telemetry!r})",
                         "A10 (telemetry)")
        cfg = cfg if cfg is not None else ServerConfig()
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.ds = dataset
        self.model = resolve_local_step(
            model if model is not None else cfg.model, dataset)
        self.het = het or HeterogeneitySim(dataset.n_clients, seed=cfg.seed)
        N = dataset.n_clients
        self.L = np.full(N, cfg.init_pair[0], np.float64)
        self.H = np.full(N, cfg.init_pair[1], np.float64)
        self.theta = np.full(N, 0.5 * sum(cfg.init_pair), np.float64)
        self.values = ValueTracker(N, dataset.sizes.astype(np.float64))
        self.sel_rng = np.random.default_rng(cfg.selection_seed)
        self.data_gen = torch.Generator(self.device).manual_seed(cfg.seed)
        self.data_draws = data_draws
        self.params = (
            self.model.init_params(
                torch.Generator(self.device).manual_seed(cfg.seed + 7))
            if init_params is None
            else params_from_reference(init_params, self.device))

        self.sizes = dataset.sizes
        self.max_n = int(self.sizes.max())
        tau_max = math.ceil(self.max_n / cfg.batch_size)
        budget = max(cfg.h_cap, cfg.fixed_epochs)
        self.max_iters = int(math.ceil(budget * tau_max))
        self.packed = dataset.packed(self.max_n, device=self.device)
        self.test_x = torch.from_numpy(dataset.test_x).to(self.device)
        self.test_y = torch.from_numpy(dataset.test_y).to(self.device)

        agg_kwargs = ({"prox_mu": cfg.prox_mu}
                      if cfg.aggregator == "fedprox" else {})
        self.engine = RoundEngine(
            lr=cfg.lr, aggregator=get_aggregator(cfg.aggregator,
                                                 **agg_kwargs),
            prox_mu=cfg.prox_mu if cfg.algo == "fedprox" else None,
            compress=cfg.upload_compress, topk_frac=cfg.topk_frac)
        # error-feedback state: one [P] float32 row per client (None when
        # the upload transform is off)
        n_params = comp.n_params_of(self.params)
        self.residual = (
            torch.zeros((dataset.n_clients, n_params), dtype=torch.float32,
                        device=self.device)
            if self.engine.compressing else None)
        self.bytes_per_client = comp.upload_bytes_per_client(
            n_params, cfg.upload_compress, cfg.topk_frac)
        self.dense_bytes_per_client = comp.upload_bytes_per_client(
            n_params, "none")
        self.round_fn = self.engine.make_packed_round(
            self.model, cfg.batch_size, self.max_iters, self.packed.max_n,
            sampling=cfg.sampling)
        self.select_fn = get_selection(cfg.selection)
        self.eval_fn = make_eval_fn(self.model)
        self.cohorts: List[np.ndarray] = []
        self.history: Dict[str, List[float]] = {k: [] for k in HISTORY_KEYS}
        self.wall_times: List[float] = []     # seconds per run() round

    # ------------------------------------------------------------------
    def _workloads(self, ids: np.ndarray, E_true: np.ndarray):
        """Per-participant uploaded epochs + history update. Returns
        (e_eff, outcome, assigned)."""
        cfg = self.cfg
        if cfg.algo == "oracle":
            # skyline: the server knows E~ in advance and assigns exactly
            # the affordable workload (upper bound for any predictor)
            e_eff = np.minimum(E_true, cfg.h_cap)
            outcome = np.where(e_eff > 0, pred.COMPLETED_H, pred.DROPPED)
            assigned = e_eff.copy()
        elif cfg.algo == "fedavg":
            ok = E_true >= cfg.fixed_epochs
            e_eff = np.where(ok, cfg.fixed_epochs, 0.0)
            outcome = np.where(ok, pred.COMPLETED_H, pred.DROPPED)
            assigned = np.full(len(ids), cfg.fixed_epochs)
        elif cfg.algo == "fedprox":
            e_eff = np.minimum(E_true, cfg.fixed_epochs)
            outcome = np.where(E_true >= cfg.fixed_epochs, pred.COMPLETED_H,
                               np.where(e_eff > 0, pred.COMPLETED_L,
                                        pred.DROPPED))
            assigned = np.full(len(ids), cfg.fixed_epochs)
        else:
            L, H = self.L[ids], self.H[ids]
            assigned = H.copy()
            e_eff = pred.uploaded_epochs(L, H, E_true)
            if cfg.algo == "ira":
                L2, H2, outcome = pred.ira_predict(L, H, E_true, U=cfg.U,
                                                   h_cap=cfg.h_cap)
            else:
                L2, H2, outcome = pred.fassa_predict(
                    L, H, E_true, self.theta[ids], cfg.gamma1, cfg.gamma2,
                    h_cap=cfg.h_cap)
                self.theta[ids] = pred.fassa_threshold(
                    self.theta[ids], E_true, cfg.alpha)
            self.L[ids], self.H[ids] = L2, H2
        return e_eff, outcome, assigned

    def _draw_round_inputs(self, t: int):
        """(E_true_all [N], ids [K]) for round t from the numpy streams."""
        cfg = self.cfg
        E_true_all = self.het.sample_round()
        if t < cfg.al_rounds:
            ids = select_active(self.sel_rng, self.values.v, cfg.n_selected,
                                cfg.beta)
        else:
            ids = self.select_fn(self.sel_rng, self.values.v,
                                 self.ds.n_clients, cfg.n_selected, cfg.beta)
        return E_true_all, ids

    # ------------------------------------------------------------------
    def run_round(self, t: int) -> Dict:
        cfg = self.cfg
        E_true_all, ids = self._draw_round_inputs(t)
        E_true = E_true_all[ids]
        e_eff, outcome, assigned = self._workloads(ids, E_true)

        # only the [K] cohort ids and budgets cross to the device; the
        # packed federation was uploaded once at construction
        n = np.minimum(self.sizes[ids], self.max_n)
        tau = np.ceil(n / cfg.batch_size)
        n_iters = np.minimum(np.round(e_eff * tau), self.max_iters)
        draws = (None if self.data_draws is None
                 else self.data_draws(t, np.asarray(ids), n))
        pk = self.packed
        out = self.round_fn(
            self.params, pk.x, pk.y, pk.offsets, pk.lengths,
            torch.as_tensor(np.asarray(ids), device=self.device),
            torch.as_tensor(n_iters.astype(np.int32), device=self.device),
            gen=self.data_gen, draws=draws, residual=self.residual)
        self.params, losses = out[0], out[1]
        if self.residual is not None:
            self.residual = out[3]
        losses = losses.cpu().numpy()     # the per-round host sync
        uploaders = n_iters > 0
        self.cohorts.append(np.asarray(ids))
        if uploaders.any():
            self.values.update(ids[uploaders], losses[uploaders])
        return {
            "round": t,
            "ids": np.asarray(ids),
            "losses": losses,
            "n_iters": n_iters,
            "dropout": float((outcome == pred.DROPPED).mean()),
            "dropped": float((outcome == pred.DROPPED).sum()),
            "overflowed": 0.0,
            "train_loss": float(losses[uploaders].mean()) if uploaders.any()
            else float("nan"),
            "assigned": float(np.mean(assigned)),
            "uploaded": float(np.mean(e_eff)),
            "true_workload": float(np.mean(E_true)),
        }

    def run(self, rounds: Optional[int] = None, verbose: bool = False,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False):
        """Run the rounds and return the history (dict of lists keyed by
        ``HISTORY_KEYS``, NaN where a round has no value).  Each round's
        host wall time, eval included, goes to ``wall_times``.  The
        reference's checkpoint keywords are accepted at their defaults
        only (ROADMAP A11)."""
        if checkpoint_dir is not None or checkpoint_every or resume:
            raise _refuse(f"FedSAEServer.run(checkpoint_dir="
                         f"{checkpoint_dir!r}, checkpoint_every="
                         f"{checkpoint_every!r}, resume={resume!r})",
                         "A11 (checkpoints)")
        T = rounds or self.cfg.rounds
        for t in range(T):
            start = time.perf_counter()
            row = self.run_round(t)
            if t % self.cfg.eval_every == 0 or t == T - 1:
                acc, tl = self.eval_fn(self.params, self.test_x, self.test_y)
                row["acc"], row["test_loss"] = float(acc), float(tl)
            else:
                prev = self.history["acc"]
                row["acc"] = prev[-1] if prev else float("nan")
                row["test_loss"] = float("nan")
            self.wall_times.append(time.perf_counter() - start)
            for k in HISTORY_KEYS:
                self.history[k].append(float(row.get(k, float("nan"))))
            if verbose and (t % 10 == 0 or t == T - 1):
                print(f"[{self.cfg.algo}] round {t:3d} acc={row['acc']:.3f} "
                      f"dropout={row['dropout']:.2f} "
                      f"loss={row['train_loss']:.3f}")
        return self.history
