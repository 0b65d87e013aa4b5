"""Public model surface of the port: ``build_model(cfg) -> Model`` and
``from_model``, the federated LM seam.

A ``Model`` bundles init / train_loss / prefill / decode_step / init_cache
for a config, as ``repro.models.api`` does: the decoder-only stacks
(``models.decoder``, a VLM with its patch projection) and the
encoder-decoder (``models.encdec``), plus ``leaf_views``, the per-layer
split of its params that the silo round trains.  ``from_model`` adapts a
decoder-only one to the ``LocalStep`` seam.

For the dry-run a ``Model`` also gives the reference's logical-axis spec
trees (``param_specs``, ``cache_specs``) and abstract inputs
(``batch_spec``: meta tensors and their axes); ``abstract_params`` and
``abstract_cache`` build params and caches on the meta device through the
ordinary ``init`` and ``init_cache``, which allocates nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, check_ported
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decoder, encdec
from repro_torch.models import layers as L

#: width of the VLM's stub frontend's patch embeddings (InternViT-300M's
#: hidden size, the reference's)
VLM_FRONTEND_DIM = 1024


META = torch.device("meta")


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]     # (generator, device=None) -> params
    prefill: Callable[[Any, Dict], Tuple[Any, Any]]
    decode_step: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    init_cache: Callable[..., Any]     # (batch, max_len, device) -> cache
    train_loss: Callable[[Any, Dict], Any]   # -> (loss, metrics)
    param_specs: Callable[[], Any]           # () -> logical-axis tree
    cache_specs: Callable[[], Any]
    batch_spec: Callable[[ShapeConfig], Tuple[Dict, Dict]]  # abstract inputs
    leaf_views: Callable[[Any], Any] = decoder.layer_views


def _vlm_patches(cfg: ArchConfig, seq_len: int) -> int:
    if not cfg.n_patches:
        return 0
    return min(cfg.n_patches, seq_len // 4)


def _decoder_batch_spec(cfg: ArchConfig, shape: ShapeConfig):
    """(meta tensor tree, logical-axes tree) of a train or prefill batch,
    the reference's: a VLM's patches take the first ``_vlm_patches``
    positions of the sequence."""
    B, S = shape.global_batch, shape.seq_len
    P = _vlm_patches(cfg, S)
    tok = torch.empty((B, S - P), dtype=torch.int32, device=META)
    batch = {"tokens": tok, "labels": tok}
    axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    if P:
        batch["patches"] = torch.empty((B, P, VLM_FRONTEND_DIM),
                                       dtype=cfg.compute_dtype, device=META)
        axes["patches"] = ("batch", None, None)
    if shape.kind == "prefill":
        del batch["labels"], axes["labels"]
    return batch, axes


def _audio_batch_spec(cfg: ArchConfig, shape: ShapeConfig):
    """(meta tensor tree, logical-axes tree) of an encoder-decoder batch:
    ``seq_len`` frames under ``min(max_decoder_len, seq_len)`` tokens."""
    B, S = shape.global_batch, shape.seq_len
    T = min(cfg.max_decoder_len, S)
    batch = {
        "frames": torch.empty((B, S, encdec.FRONTEND_DIM),
                              dtype=cfg.compute_dtype, device=META),
        "tokens": torch.empty((B, T), dtype=torch.int32, device=META),
        "labels": torch.empty((B, T), dtype=torch.int32, device=META),
    }
    axes = {"frames": ("batch", None, None), "tokens": ("batch", None),
            "labels": ("batch", None)}
    if shape.kind == "prefill":
        del batch["labels"], axes["labels"]
    return batch, axes


def _cache_device(device: DeviceLike):
    """The cache's device: "meta" as it is (``abstract_cache``), any other
    through ``resolve_device``."""
    if device is not None and torch.device(device).type == "meta":
        return META
    return resolve_device(device)


def build_model(cfg: ArchConfig) -> Model:
    """The config's ``Model``.  An encoder-decoder's ``init_cache(batch,
    max_len)`` holds ``max_len`` frames of cross K/V and
    ``max_decoder_len`` self-attention slots, as the reference's."""
    check_ported(cfg)
    if cfg.is_encoder_decoder:
        def enc_cache(batch: int, max_len: int, device: DeviceLike = None):
            return encdec.init_cache(cfg, batch, enc_len=max_len,
                                     dec_len=cfg.max_decoder_len,
                                     device=_cache_device(device))

        return Model(
            cfg=cfg,
            init=lambda generator, device=None: encdec.init_params(
                generator, cfg, device),
            prefill=lambda p, b: encdec.prefill(p, cfg, b),
            decode_step=lambda p, c, t, i: encdec.decode_step(p, cfg, c, t,
                                                              i),
            init_cache=enc_cache,
            train_loss=lambda p, b: encdec.train_loss(p, cfg, b),
            param_specs=lambda: encdec.param_specs(cfg),
            cache_specs=lambda: encdec.cache_specs(cfg),
            batch_spec=lambda s: _audio_batch_spec(cfg, s),
            leaf_views=encdec.layer_views,
        )

    extra = VLM_FRONTEND_DIM if cfg.n_patches else 0

    def init_cache(batch: int, max_len: int, device: DeviceLike = None):
        return decoder.init_cache(cfg, batch, max_len, _cache_device(device))

    return Model(
        cfg=cfg,
        init=lambda generator, device=None: decoder.init_params(
            generator, cfg, extra, device),
        prefill=lambda p, b: decoder.prefill(p, cfg, b),
        decode_step=lambda p, c, t, i: decoder.decode_step(p, cfg, c, t, i),
        init_cache=init_cache,
        train_loss=lambda p, b: decoder.train_loss(p, cfg, b),
        param_specs=lambda: decoder.param_specs(cfg, extra),
        cache_specs=lambda: decoder.cache_specs(cfg),
        batch_spec=lambda s: _decoder_batch_spec(cfg, s),
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


def abstract_params(model: Model):
    """The params tree on the meta device: the reference's shapes and
    dtypes (its ``jax.eval_shape`` of ``init``), no storage allocated."""
    return model.init(torch.Generator(), device=META)


def abstract_cache(model: Model, batch: int, max_len: int):
    """The decode cache on the meta device (``init_cache``' shapes and
    dtypes, no storage)."""
    return model.init_cache(batch, max_len, device=META)
