"""Test-set evaluation of the global model."""
from __future__ import annotations

from typing import Callable

import torch


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
