"""Cross-silo FedSAE: the paper's scheduling algebra applied to production
models, the port's copy of ``repro/core/silo.py``.

Each silo trains the full architecture; the workload unit is the local
step (paper §IV-A allows fractional epochs == iterations).  Every round,
Ira predicts each silo's easy and hard budgets (L, H) from the
heterogeneity simulator's affordable workloads, each silo runs the steps
it completes, and FedAvg mixes the uploads weighted by silo size.  The
host algebra is the reference's numpy, bit for bit; local training and
aggregation go through ``RoundEngine.make_stream_round``.  Each round
emits one ``RoundRecord`` through the same sink interface as
``FedSAEServer`` (``fl_train --metrics-out``).  With ``screen_norm`` the
engine's upload screen runs before the aggregator (leaf row by leaf row,
in place, so a full-width stack gets no second copy) and the record
carries the round's ``screened`` count.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_reference
from repro_torch.core import prediction as pred
from repro_torch.core.aggregation import get_aggregator
from repro_torch.core.engine import RoundEngine
from repro_torch.core.heterogeneity import HeterogeneitySim
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.schema import record_from_row
from repro_torch.obs.sinks import NullSink, Sink
from repro_torch.tree import tree_map


def make_silo_round_fn(loss_fn: Callable, lr: float, max_steps: int):
    """loss_fn(params, batch) -> scalar (or a ``LocalStep``).  Returns
    round_fn(global_params, batches, n_steps, weights) -> (new_global,
    silo_mean_losses), FedAvg over the silos (``make_stream_round``)."""
    engine = RoundEngine(lr=lr, aggregator=get_aggregator("fedavg"))
    return engine.make_stream_round(loss_fn, max_steps)


class SiloFedSAE:
    """FedSAE-Ira over K silos training a production model.

    ``model`` is a ``models.api.Model`` (trained through its
    ``train_loss``, one autograd leaf per layer via its ``leaf_views``; a
    decoder-only, VLM or encoder-decoder config) or a ``LocalStep``.
    ``init_params`` (a dict of numpy arrays, e.g. the reference's init)
    replaces the torch-drawn init, which cannot reproduce the reference's
    threefry draws.  ``device`` defaults to cuda.  ``sink`` receives one
    ``RoundRecord`` a round.  ``screen_norm`` turns the upload screen on
    with that delta l2 bound: a rejected silo is aggregated as a crashed
    one (weight 0, the global params' value)."""

    def __init__(self, model, n_silos: int, lr: float = 5e-3,
                 max_steps: int = 16, U: float = 2.0, seed: int = 0,
                 aggregator: str = "fedavg", sink: Optional[Sink] = None,
                 screen_norm: Optional[float] = None, init_params=None,
                 device: DeviceLike = None, **agg_kwargs):
        from repro_torch.models.fl_models import LocalStep, as_local_step

        if hasattr(model, "train_loss"):
            step = LocalStep(
                init_params=model.init,
                loss=lambda p, b: model.train_loss(p, b)[0],
                name=getattr(getattr(model, "cfg", None), "name", None),
                leaf_views=getattr(model, "leaf_views", None))
        else:
            step = as_local_step(model)
        self.device = resolve_device(device)
        self.model = model
        self.step = step
        self.K = n_silos
        self.max_steps = max_steps
        self.U = U
        # workload here is "local steps"; the paper's mu in [5, 10) epochs
        # is mapped onto [max_steps/2, max_steps) local steps
        self.het = HeterogeneitySim(n_silos, seed=seed)
        self.steps_scale = max_steps / 10.0
        self.L = np.full(n_silos, 1.0)
        self.H = np.full(n_silos, 2.0)
        self.params = (
            step.init_params(torch.Generator(self.device).manual_seed(seed))
            if init_params is None
            else params_from_reference(init_params, self.device))
        self.engine = RoundEngine(
            lr=lr, aggregator=get_aggregator(aggregator, **agg_kwargs),
            screen_norm=screen_norm)
        self.round_fn = self.engine.make_stream_round(step, max_steps)
        self.stats: Dict[str, list] = {"loss": [], "dropout": [],
                                       "uploaded_steps": []}
        self.last_n_steps: Optional[np.ndarray] = None
        self.sink: Sink = sink if sink is not None else NullSink()
        self.round_idx = 0

    def run_round(self, batches, sizes: np.ndarray):
        """batches: tree of arrays or tensors with leading [K, max_steps,
        ...] (moved to the device here): tokens and labels, and a VLM's
        patches or an encoder-decoder's frames, as the model's
        ``train_loss`` takes a batch."""
        t_start = time.perf_counter()
        E_true = np.minimum(self.het.sample_round() * self.steps_scale,
                            self.max_steps)
        assigned = self.H.copy()
        e_eff = pred.uploaded_epochs(self.L, self.H, E_true)
        self.L, self.H, outcome = pred.ira_predict(
            self.L, self.H, E_true, U=self.U, h_cap=float(self.max_steps))
        n_steps = np.round(e_eff).astype(np.int32)
        weights = np.asarray(sizes).astype(np.float32) * (n_steps > 0)
        batches = tree_map(lambda b: torch.as_tensor(b, device=self.device),
                           batches)
        out = self.round_fn(self.params, batches, n_steps,
                            torch.as_tensor(weights, device=self.device))
        self.params, losses = out[0], out[1]
        screened = (float(out[2].sum()) if self.engine.screening
                    else None)
        self.last_n_steps = n_steps
        self.stats["loss"].append(float(losses.mean()))
        self.stats["dropout"].append(float((outcome == pred.DROPPED).mean()))
        self.stats["uploaded_steps"].append(float(e_eff.mean()))
        row = {
            "wall_time_s": time.perf_counter() - t_start,
            "train_loss": self.stats["loss"][-1],
            "dropout": self.stats["dropout"][-1],
            "dropped": float((outcome == pred.DROPPED).sum()),
            "assigned": float(assigned.mean()),
            "uploaded": self.stats["uploaded_steps"][-1],
            "true_workload": float(E_true.mean()),
            "ids": np.arange(self.K),
            "client_uploaded": (n_steps > 0).astype(np.int32),
        }
        if screened is not None:
            row["screened"] = screened
        self.sink.emit(record_from_row(self.round_idx, row))
        self.round_idx += 1
        return self.stats
