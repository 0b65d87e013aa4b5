"""Optimizers of the port (copies of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
    global_norm,
    sgd,
)
