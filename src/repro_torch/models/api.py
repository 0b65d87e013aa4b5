"""Public model surface of the port: ``build_model(cfg) -> Model``.

A ``Model`` bundles init / prefill / decode_step / init_cache for a
decoder-only config, as ``repro.models.api`` does.  The encoder-decoder,
``train_loss`` and ``from_model`` (the federated LM seam) are ROADMAP
A13 (ii) and (i).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, check_ported
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decoder


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable[[torch.Generator], Any]           # generator -> params
    prefill: Callable[[Any, Dict], Tuple[Any, Any]]
    decode_step: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    init_cache: Callable[..., Any]     # (batch, max_len, device) -> cache
    train_loss: Callable[[Any, Dict], Any]


def build_model(cfg: ArchConfig) -> Model:
    check_ported(cfg)

    def init_cache(batch: int, max_len: int, device: DeviceLike = None):
        return decoder.init_cache(cfg, batch, max_len, resolve_device(device))

    return Model(
        cfg=cfg,
        init=lambda generator: decoder.init_params(generator, cfg),
        prefill=lambda p, b: decoder.prefill(p, cfg, b),
        decode_step=lambda p, c, t, i: decoder.decode_step(p, cfg, c, t, i),
        init_cache=init_cache,
        train_loss=lambda p, b: decoder.train_loss(p, cfg, b),
    )
