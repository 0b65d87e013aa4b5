"""Step builders of the port: train, prefill and decode steps over a
``models.api.Model``, the counterparts of ``repro/launch/steps.py``.

The reference also derives XLA shardings and lowers steps on a mesh
(``shardings_from_specs``, ``lower_step``, ``opt_state_specs``); that is
mesh tooling with no counterpart on one card (ROADMAP A14).
"""
from __future__ import annotations

import torch

from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_leaves, tree_map


def make_optimizer(name: str, lr: float = 1e-4):
    if name == "sgd":
        return sgd(lr)
    if name == "adamw":
        return adamw(lr)
    raise ValueError(name)


def _restack(tree):
    """A gradient tree over ``leaf_views`` back in the params' layout: each
    list of per-layer gradients stacked into one [G, ...] tensor."""
    if isinstance(tree, dict):
        return {k: _restack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return torch.stack(tree)
    return tree


def make_train_step(model, optimizer):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss).

    The gradient of ``model.train_loss`` is taken over the model's
    ``leaf_views`` (one autograd leaf per layer), then restacked, and the
    optimizer's update returns new params and state.  A leaf the loss does
    not read gets a zero gradient, as under ``jax.value_and_grad``."""
    views = getattr(model, "leaf_views", None) or (lambda p: p)

    def train_step(params, opt_state, batch):
        tree = views(tree_map(torch.Tensor.detach, params))
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.train_loss(tree, batch)
        grads = iter(torch.autograd.grad(loss, leaves,
                                         materialize_grads=True))
        for p in leaves:
            p.requires_grad_(False)
        gtree = _restack(tree_map(lambda _: next(grads), tree))
        with torch.no_grad():
            params, opt_state = optimizer.update(gtree, opt_state, params)
        return params, opt_state, loss.detach()
    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens, cur_index):
        with torch.inference_mode():
            return model.decode_step(params, cache, tokens, cur_index)
    return decode_step
