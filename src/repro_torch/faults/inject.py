"""Seeded fault draws and upload corruption: the injection half of the
fault layer, the port's counterpart of ``repro/faults/inject.py``.

Every draw here is a pure function of ``(FaultModel.seed, t, axis)``,
made on the host:

    straggler slowdowns  <- default_rng((seed, t, 0))
    dropout mask         <- default_rng((seed, t, 1))
    corrupt mask         <- default_rng((seed, t, 2))

No state is carried between rounds and nothing is split from the training
or selection streams, so a CPU run and a card run of one config draw the
same schedule, and a resumed run replays it.  All masks are drawn over
the full [N] population and gathered at the selected ids, so the schedule
does not depend on how the cohort was selected.  The reference keys the
same axes as ``fold_in(fold_in(PRNGKey(seed), t), axis)``, threefry bits
torch cannot replay; ``FedSAEServer(fault_draws=)`` takes the reference's
masks and slowdowns in place of these.

The device drivers read the same draws from the device: before each
block of rounds ``block_fault_draws`` stacks rounds t0 .. t0 + b - 1 (or
``fault_draws=``'s) into [b, N] tensors, copied to the device once, and
``apply_availability_stragglers_device`` is the float32 twin of the
workload shaping with the round index on the device.

``inject_upload_faults`` is the wire-corruption primitive: given the
stacked post-SGD uploads it overwrites the corrupt rows with the mode's
garbage.  It runs at the engine's upload-transform seam, never inside
client training, so the corrupted bytes are exactly what the server's
screen (``faults.screen``) must catch.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.heterogeneity import pareto_slowdowns
from repro_torch.faults.model import INJECTED_CORRUPT, FaultModel
from repro_torch.tree import tree_map

#: the fault stream's axes (the reference's sub-folds 0/1/2)
STRAGGLER_AXIS, DROPOUT_AXIS, CORRUPT_AXIS = 0, 1, 2


def round_fault_rng(seed: int, t: int, axis: int) -> np.random.Generator:
    """The generator of one axis of round ``t``'s faults: stateless in t."""
    return np.random.default_rng((int(seed), int(t), int(axis)))


def straggler_slowdowns(fm: FaultModel, t: int,
                        n_clients: int) -> Optional[np.ndarray]:
    """float32 [N] Pareto slowdowns >= 1 (None unless straggler="pareto")."""
    if fm.straggler != "pareto":
        return None
    return pareto_slowdowns(round_fault_rng(fm.seed, t, STRAGGLER_AXIS),
                            fm.pareto_alpha, (n_clients,))


def dropout_mask(fm: FaultModel, t: int,
                 n_clients: int) -> Optional[np.ndarray]:
    """bool [N]: mid-round dropouts this round (None when disabled)."""
    if fm.dropout_prob <= 0.0:
        return None
    u = round_fault_rng(fm.seed, t, DROPOUT_AXIS).random(n_clients)
    return u < fm.dropout_prob


def corrupt_mask(fm: FaultModel, t: int,
                 n_clients: int) -> Optional[np.ndarray]:
    """bool [N]: corrupted-upload draws this round (None when disabled)."""
    if not fm.corrupts:
        return None
    u = round_fault_rng(fm.seed, t, CORRUPT_AXIS).random(n_clients)
    return u < fm.corrupt_prob


def round_fault_draws(fm: FaultModel, t: int, n_clients: int) -> Dict:
    """Round ``t``'s draws: ``slowdown`` (float32 [N]), ``dropout`` and
    ``corrupt`` (bool [N]), each None when its axis is off.  The shape of
    ``FedSAEServer(fault_draws=)``'s result."""
    return {"slowdown": straggler_slowdowns(fm, t, n_clients),
            "dropout": dropout_mask(fm, t, n_clients),
            "corrupt": corrupt_mask(fm, t, n_clients)}


def availability_mask(fm: FaultModel, phases, t: int):
    """bool [N]: which clients are on duty at round ``t`` (diurnal trace).

    Client i is on for the first ``duty_len`` rounds of its phase-shifted
    ``day_rounds``-round day.
    """
    return ((t + phases) % fm.day_rounds) < fm.duty_len


def apply_availability_stragglers(fm: FaultModel, phases, t: int,
                                  E_all: np.ndarray,
                                  slowdown: Optional[np.ndarray] = None
                                  ) -> np.ndarray:
    """Pre-selection workload shaping over the full [N] draw, in float64
    (the host driver's numpy math).

    Pareto slowdowns divide the Gaussian-sim workload (``slowdown``, round
    t's draw by default); off-duty clients are zeroed afterwards, so an
    unavailable client contributes exactly E=0 (the existing zero-budget
    crash branch absorbs it).  A FaultModel with neither leaves ``E_all``
    untouched.
    """
    if fm.straggler == "pareto":
        if slowdown is None:
            slowdown = straggler_slowdowns(fm, t, len(E_all))
        E_all = E_all / np.asarray(slowdown, np.float64)
    if fm.availability == "diurnal":
        E_all = np.where(availability_mask(fm, phases, t), E_all, 0.0)
    return E_all


def apply_availability_stragglers_device(fm: FaultModel, phases, t, E_all,
                                         slowdown=None):
    """Float32 twin of :func:`apply_availability_stragglers` on the device:
    ``E_all / slowdown`` (float32 [N]), then off-duty clients zeroed.
    ``phases`` is the int32 [N] tensor of ``fm.phases``; ``t`` the round
    index, an int or a 0-d device tensor."""
    if fm.straggler == "pareto":
        E_all = E_all / slowdown
    if fm.availability == "diurnal":
        E_all = torch.where(availability_mask(fm, phases, t), E_all, 0.0)
    return E_all


def block_fault_draws(fm: FaultModel, t0: int, b: int, n_clients: int,
                      fault_draws=None) -> Dict:
    """Rounds ``t0 .. t0 + b - 1``'s draws stacked per axis: ``slowdown``
    float32 [b, N], ``dropout`` and ``corrupt`` bool [b, N] (numpy; an
    axis that is off is absent).  ``fault_draws(t)`` replaces
    :func:`round_fault_draws` as in ``FedSAEServer(fault_draws=)``."""
    draw = fault_draws or (lambda t: round_fault_draws(fm, t, n_clients))
    rows = [draw(t) for t in range(t0, t0 + b)]
    out = {}
    for name, dtype in (("slowdown", np.float32), ("dropout", bool),
                        ("corrupt", bool)):
        if rows[0].get(name) is not None:
            out[name] = np.stack([np.asarray(r[name], dtype) for r in rows])
    return out


def inject_upload_faults(params_k, global_params, mask, mode: str,
                         factor: float = 1e8):
    """Overwrite the masked rows of a stacked upload with garbage.

    params_k        dict of [K, ...] stacked client uploads
    global_params   matching unstacked dict (broadcasts against rows)
    mask            bool [K] tensor: rows to corrupt
    mode            "nan" | "inf" | "sign_flip" | "explode"

    sign_flip sends ``g - (p - g)`` (the delta's mirror image: finite,
    norm-identical to the honest delta, so it passes the screen); explode
    sends ``g + factor * (p - g)``.  Returns a new stack; rows outside the
    mask keep their bits.
    """
    if mode not in INJECTED_CORRUPT:
        raise ValueError(f"not an injected corrupt mode: {mode!r}")

    def row(p, g):
        m = mask.reshape((-1,) + (1,) * (p.dim() - 1))
        if mode == "nan":
            garbage = torch.full_like(p, float("nan"))
        elif mode == "inf":
            garbage = torch.full_like(p, float("inf"))
        elif mode == "sign_flip":
            garbage = 2.0 * g - p
        else:  # explode: the factor rounded to p's dtype, as a scalar
            garbage = g + float(torch.tensor(factor, dtype=p.dtype)) * (p - g)
        return torch.where(m, garbage, p)

    return tree_map(row, params_k, global_params)
