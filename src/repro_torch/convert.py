"""Params between the JAX package and the port, as numpy arrays.

``params_from_reference`` turns the reference's params (a dict of numpy
arrays, e.g. ``jax.tree.map(np.asarray, params)``) into the port's tensors,
so that both packages can start from the same init; ``params_to_numpy``
goes the other way.  Neither imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_reference(np_tree, device: DeviceLike = None):
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(dev)

    return conv(np_tree)


def params_to_numpy(params):
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
