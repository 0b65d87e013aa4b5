"""Optimizers, the port's copy of ``repro/optim/optimizers.py``.

Each optimizer is an (init, update) pair over a params tree:

    state = init(params)
    new_params, new_state = update(grads, state, params)

with the reference's operations in the reference's order, so that updates
agree with it elementwise to float32 rounding.  Plain SGD is the paper's
local optimizer; AdamW (b2 = 0.95, warmup, clip 1.0) drives the
centralized training driver.  Updates return new tensors; the step count
is a 0-d int32 tensor on the params' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
        grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mu": tree_map(torch.zeros_like, params),
                    "step": _step0(params)}
        return {"step": _step0(params)}

    def update(grads, state, params):
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads,
                             params)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            new_params = tree_map(lambda p, m: p - lr * m, params, mu)
            return new_params, {"mu": mu, "step": state["step"] + 1}
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
        return new_params, {"step": state["step"] + 1}

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: float = 1.0,
          warmup_steps: int = 0) -> Optimizer:
    f32 = torch.float32

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=f32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params):
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        step = state["step"] + 1
        t = step.to(f32)
        sched = (torch.clamp(t / max(1, warmup_steps), max=1.0)
                 if warmup_steps else 1.0)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(f32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.to(f32)), state["v"], grads)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=t.device), t)
        mh = tree_map(lambda m_: m_ / bc1, m)
        vh = tree_map(lambda v_: v_ / bc2, v)

        def upd(p, mh_, vh_):
            delta = mh_ / (torch.sqrt(vh_) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(f32)
            return (p.to(f32) - lr * sched * delta).to(p.dtype)

        new_params = tree_map(upd, params, mh, vh)
        return new_params, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)
