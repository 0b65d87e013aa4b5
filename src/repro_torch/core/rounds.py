"""The seed interface's round and the test-set evaluation of the global
model: thin wrappers over ``repro_torch.core.engine.RoundEngine``, which
owns the local-SGD and aggregation machinery of every training path.
New code should build a ``RoundEngine`` to pick aggregation and
selection policies."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.aggregation import get_aggregator
from repro_torch.core.engine import RoundEngine


def make_round_fn(model, lr: float, batch_size: int, max_iters: int,
                  prox_mu: float = 0.0, sampling: str = "shuffle",
                  backend: str = "xla") -> Callable:
    """The round function of a ``LocalStep`` (any loss/accuracy model of
    ``repro_torch.models.fl_models``; duck-typed triples are coerced).

    round_fn(global_params, x, y, mask, n, n_iters, gen=None, draws=None)
        -> (new_global_params, client_losses, uploaded_any)
      x: [K, M, ...] padded client data;  mask: [K, M]
      n: [K] true sample counts;  n_iters: [K] masked local-SGD budget

    The minibatch draws come from the ``torch.Generator`` ``gen`` or are
    ``draws`` (``RoundEngine.make_padded_round``).  ``backend`` is
    validated and selects nothing: on a CUDA tensor an iid MCLR or MLP
    step always trains through its fused kernel
    (``repro_torch.kernels.ops.fused_sgd_eligible``), any other step
    through the plain autodiff walk."""
    engine = RoundEngine(lr=lr, aggregator=get_aggregator("fedavg"),
                         prox_mu=prox_mu, donate=False, backend=backend)
    return engine.make_padded_round(model, batch_size, max_iters,
                                    sampling=sampling)


def make_eval_fn(model) -> Callable:
    """eval_fn(params, x, y) -> (accuracy, loss), both 0-d tensors on the
    params' device.  Steps without an ``accuracy`` report NaN accuracy and
    the test loss."""
    @torch.no_grad()
    def eval_fn(params, x, y):
        batch = {"x": x, "y": y}
        acc = (model.accuracy(params, batch)
               if getattr(model, "accuracy", None) is not None
               else torch.tensor(float("nan"), device=x.device))
        return acc, model.loss(params, batch)
    return eval_fn
