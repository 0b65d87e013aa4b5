"""Upload-transform stage: top-k delta sparsification + int8 quantisation
with per-client error feedback.

It sits between local SGD and aggregation in the round
(gather -> local SGD -> UPLOAD TRANSFORM -> aggregate):

  1. delta_k = params_k - global
  2. ef_k    = delta_k + residual_k             (last round's discarded
                                                 mass re-enters before
                                                 selection)
  3. (q_k, scale_k) = topk_q8(ef_k)             (k = ceil(topk_frac * P)
                                                 int8 coordinates + one f32
                                                 scale: the wire format)
  4. transmitted_k = q_k * scale_k              (dense reconstruction on the
                                                 server, so any aggregator
                                                 sees a dense [K, ...] stack)
  5. residual_k'  = ef_k - transmitted_k        (carried to the next round)

``transmitted + residual' == delta + residual`` holds EXACTLY in float32:
each selected coordinate and its dequantised value lie within a factor of
two of each other, so (5) is an exact subtraction (Sterbenz), and the other
coordinates transmit exactly 0.0.  That needs ``transmitted`` rounded to
float32 as a value of its own before (5) and before ``global +
transmitted``: eager PyTorch runs each op as its own kernel, so nothing
contracts ``ef - q * scale`` into an FMA.  Never put this module under
``torch.compile``.

Residuals are per-client state: zero-budget and unselected clients
transmit nothing and keep their residual bit for bit.

This module also owns the flatten contract: ``flatten_global`` ravels a
params dict to a float32 ``[P]`` vector in sorted-key order (the
reference's ``jax.tree.leaves`` order) and ``unflatten_rows`` maps a
``[K, P]`` stack back to per-leaf shapes and dtypes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.aggregation import _flatten_clients, _unflatten_like
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves

COMPRESS_MODES = ("none", "topk_q8")

# simulated wire format per uploading client: k (int32 index + int8 value)
# pairs plus one float32 scale
BYTES_INDEX = 4
BYTES_VALUE = 1
BYTES_SCALE = 4
BYTES_DENSE = 4   # float32 coordinate in the uncompressed upload


def check_compress(compress: str) -> str:
    if compress not in COMPRESS_MODES:
        raise ValueError(f"unknown upload_compress {compress!r}; "
                         f"choose from {COMPRESS_MODES}")
    return compress


def resolve_k(topk_frac: float, n_params: int) -> int:
    """Kept-coordinate count: ceil(topk_frac * P), clamped to [0, P]."""
    frac = float(topk_frac)
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"topk_frac must be in [0, 1], got {topk_frac}")
    return max(0, min(int(math.ceil(frac * n_params)), int(n_params)))


def upload_bytes_per_client(n_params: int, compress: str = "none",
                            topk_frac: float = 0.1) -> int:
    """Simulated upload bytes one client ships per round."""
    if check_compress(compress) == "none":
        return int(n_params) * BYTES_DENSE
    k = resolve_k(topk_frac, n_params)
    return k * (BYTES_INDEX + BYTES_VALUE) + BYTES_SCALE


def flatten_global(global_params) -> torch.Tensor:
    """Params tree -> [P] float32 vector (leaves in sorted-key order)."""
    return torch.cat([v.reshape(-1).to(torch.float32)
                      for v in tree_leaves(global_params)])


def n_params_of(global_params) -> int:
    return sum(v.numel() for v in tree_leaves(global_params))


def unflatten_rows(mat, global_params):
    """[K, P] float32 -> stacked client dict shaped like global_params with
    a leading K axis (the aggregators' input layout)."""
    return _unflatten_like(mat, global_params)


def compress_rows(ef, k: int):
    """(q [K, P] int8, scale [K] f32) through the kernel op: the Hopper
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    return kops.fed_compress_topk_q8(ef, k)


def apply_upload_compress(global_params, params_k, residual_rows, uploaded,
                          k: int):
    """Run the upload transform on a trained client stack.

    global_params : the round's incoming global dict
    params_k      : stacked client dict (leading axis K) after local SGD
    residual_rows : [K, P] f32 error-feedback residuals of these clients
    uploaded      : [K] bool; False rows transmit nothing and keep their
                    residual unchanged
    k             : kept-coordinate count (``resolve_k``)

    Returns (reconstructed_params_k, new_residual_rows, transmitted_rows):
    ``global + q * scale`` per uploading row (a non-uploader reconstructs
    to exactly ``global``), the updated residuals and the transmitted
    rows."""
    g = flatten_global(global_params)                       # [P]
    delta = _flatten_clients(params_k) - g[None, :]         # [K, P]
    up = uploaded[:, None]
    ef = delta + residual_rows
    q, scale = compress_rows(ef, k)
    # its own rounded tensor: ``ef - transmitted`` and ``g + transmitted``
    # below must not see an unrounded q * scale (see the module docstring)
    transmitted = torch.where(up, q.to(torch.float32) * scale[:, None],
                              torch.zeros((), device=ef.device))
    new_residual = torch.where(up, ef - transmitted, residual_rows)
    reconstructed = unflatten_rows(g[None, :] + transmitted, global_params)
    return reconstructed, new_residual, transmitted
