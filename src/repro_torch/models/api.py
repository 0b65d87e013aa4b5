"""Public model surface of the port: ``build_model(cfg) -> Model`` and
``from_model``, the federated LM seam.

A ``Model`` bundles init / train_loss / prefill / decode_step / init_cache
for a config, as ``repro.models.api`` does: the decoder-only stacks
(``models.decoder``, a VLM with its patch projection) and the
encoder-decoder (``models.encdec``), plus ``leaf_views``, the per-layer
split of its params that the silo round trains.  ``from_model`` adapts a
decoder-only one to the ``LocalStep`` seam.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, check_ported
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decoder, encdec
from repro_torch.models import layers as L

#: width of the VLM's stub frontend's patch embeddings (InternViT-300M's
#: hidden size, the reference's)
VLM_FRONTEND_DIM = 1024


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable[[torch.Generator], Any]           # generator -> params
    prefill: Callable[[Any, Dict], Tuple[Any, Any]]
    decode_step: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    init_cache: Callable[..., Any]     # (batch, max_len, device) -> cache
    train_loss: Callable[[Any, Dict], Any]   # -> (loss, metrics)
    leaf_views: Callable[[Any], Any] = decoder.layer_views


def build_model(cfg: ArchConfig) -> Model:
    """The config's ``Model``.  An encoder-decoder's ``init_cache(batch,
    max_len)`` holds ``max_len`` frames of cross K/V and
    ``max_decoder_len`` self-attention slots, as the reference's."""
    check_ported(cfg)
    if cfg.is_encoder_decoder:
        def enc_cache(batch: int, max_len: int, device: DeviceLike = None):
            return encdec.init_cache(cfg, batch, enc_len=max_len,
                                     dec_len=cfg.max_decoder_len,
                                     device=resolve_device(device))

        return Model(
            cfg=cfg,
            init=lambda generator: encdec.init_params(generator, cfg),
            prefill=lambda p, b: encdec.prefill(p, cfg, b),
            decode_step=lambda p, c, t, i: encdec.decode_step(p, cfg, c, t,
                                                              i),
            init_cache=enc_cache,
            train_loss=lambda p, b: encdec.train_loss(p, cfg, b),
            leaf_views=encdec.layer_views,
        )

    extra = VLM_FRONTEND_DIM if cfg.n_patches else 0

    def init_cache(batch: int, max_len: int, device: DeviceLike = None):
        return decoder.init_cache(cfg, batch, max_len, resolve_device(device))

    return Model(
        cfg=cfg,
        init=lambda generator: decoder.init_params(generator, cfg, extra),
        prefill=lambda p, b: decoder.prefill(p, cfg, b),
        decode_step=lambda p, c, t, i: decoder.decode_step(p, cfg, c, t, i),
        init_cache=init_cache,
        train_loss=lambda p, b: decoder.train_loss(p, cfg, b),
    )


def from_model(cfg_or_model, lm_seq_len: Optional[int] = None):
    """Adapt a decoder-only architecture (a config or its ``Model``) to
    the federated ``LocalStep`` seam (``repro_torch.models.fl_models``),
    as the reference's ``from_model``; an encoder-decoder raises its
    ``ValueError``.

    A client batch is ``{"x": tokens [B, S] int, "y": labels [B], "mask":
    [B] row validity}``.  The loss is the causal-LM objective:
    ``tokens[:, :-1]`` predicts ``tokens[:, 1:]`` and the row mask
    broadcasts to a [B, S-1] token mask, so padded rows contribute exactly
    zero (``decoder.train_loss`` takes the masked mean).  ``y`` is
    ignored; a VLM trains on the tokens alone (its ``modality_proj`` gets
    a zero gradient).  Accuracy is teacher-forced next-token accuracy over the
    same masked positions.  ``lm_seq_len`` keeps the first tokens of each
    row.  The step's ``leaf_views`` is the model's, so the silo round
    trains per-layer leaves."""
    from repro_torch.models.fl_models import LocalStep

    if isinstance(cfg_or_model, Model):
        model, cfg = cfg_or_model, cfg_or_model.cfg
    else:
        cfg = cfg_or_model
        model = None
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"from_model supports decoder-only architectures; "
            f"{cfg.name} is encoder-decoder")
    model = model or build_model(cfg)

    def lm_batch(batch):
        tokens = batch["x"].to(torch.int32)
        if lm_seq_len is not None:
            tokens = tokens[:, :lm_seq_len]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        row = batch.get("mask")
        tok_mask = (torch.ones(labels.shape, dtype=torch.bool,
                               device=labels.device) if row is None
                    else (row > 0)[:, None].expand(labels.shape))
        return inputs, labels, tok_mask

    def loss(params, batch):
        inputs, labels, tok_mask = lm_batch(batch)
        value, _ = model.train_loss(
            params, {"tokens": inputs, "labels": labels, "mask": tok_mask})
        return value

    def accuracy(params, batch):
        inputs, labels, tok_mask = lm_batch(batch)
        B, S = inputs.shape
        h = decoder.embed_inputs(params, cfg, {"tokens": inputs})
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        h, _, _ = decoder.forward(params, cfg, h, positions, "train")
        pred = torch.argmax(L.logits_fn(params["embeddings"], cfg, h), -1)
        hit = ((pred == labels) & tok_mask).sum()
        return hit / torch.clamp(tok_mask.sum(), min=1)

    return LocalStep(init_params=model.init, loss=loss, accuracy=accuracy,
                     kind="lm", name=f"model:{cfg.name}",
                     leaf_views=model.leaf_views)
