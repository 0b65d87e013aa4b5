"""Whisper-style encoder-decoder (the audio family), the port's copy of
``repro/models/encdec.py``.

The mel-spectrogram and conv feature extractor is a stub, as in the
reference: a batch carries precomputed frame embeddings ``frames`` [B, F,
FRONTEND_DIM].  This module is the transformer encoder over them and the
causal decoder with cross-attention: teacher-forced training, prefill and
cached decode.  The encoder's self-attention is non-causal with RoPE and
the decoder's causal; both go through the flash-attention op (the kernel
on a CUDA tensor, its plain version on a CPU one).  Cross-attention is
plain torch (``layers.attention_ref``), as the reference computes it
outside any kernel: only its query side is RMS-normed, its K and V are
projections of the encoder output, which ``enc_norm`` has normed.  The
layers are walked by Python loops where the reference scans; like the
reference, neither stack is recomputed in the backward (``cfg.remat`` is
not read here).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import check_ported
from repro_torch.models import decoder
from repro_torch.models import layers as L

#: width of the stub frontend's frame embeddings (the reference's)
FRONTEND_DIM = 128

#: logical axes of a cross-attention block's leaves (the reference's)
CROSS_SPECS = {
    "wq": ("fsdp", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "fsdp"),
    "norm": ("embed",),
}


def init_params(generator: torch.Generator, cfg, device=None):
    """Params on the generator's device (or on ``device``, "meta" for
    shapes alone), the reference's tree:
    {"embeddings", "enc_proj" [FRONTEND_DIM, d], "enc_blocks": {"attn",
    "ffn"}, "dec_blocks": {"self", "cross", "ffn"}, "enc_norm"}, block
    leaves stacked over the layers.  Parity runs hand the reference's
    params in (``repro_torch.convert.params_from_reference``)."""
    check_ported(cfg)
    device = generator.device if device is None else torch.device(device)
    G_enc, G_dec = cfg.n_encoder_layers, cfg.n_layers
    dt = cfg.params_dtype
    return {
        "embeddings": L.init_embeddings(generator, cfg, device),
        "enc_proj": L.dense_init(generator, (FRONTEND_DIM, cfg.d_model), dt,
                                 device=device),
        "enc_blocks": {
            "attn": L.init_attention(generator, cfg, device, stack=G_enc),
            "ffn": L.init_ffn(generator, cfg, device=device, stack=G_enc)},
        "dec_blocks": {
            "self": L.init_attention(generator, cfg, device, stack=G_dec),
            "cross": L.init_attention(generator, cfg, device, stack=G_dec),
            "ffn": L.init_ffn(generator, cfg, device=device, stack=G_dec)},
        "enc_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }


def param_specs(cfg):
    """The reference's logical-axis spec tree of ``init_params``' tree."""
    lift = decoder._lift
    specs = {
        "embeddings": dict(L.EMB_SPECS),
        "enc_proj": ("none", "embed"),
        "enc_blocks": lift({"attn": dict(L.ATTN_SPECS),
                            "ffn": dict(L.FFN_SPECS)}),
        "dec_blocks": lift({"self": dict(L.ATTN_SPECS),
                            "cross": dict(CROSS_SPECS),
                            "ffn": dict(L.FFN_SPECS)}),
        "enc_norm": ("embed",),
    }
    if cfg.tie_embeddings:
        del specs["embeddings"]["unembed"]
    return specs


def cache_specs(cfg):
    """The reference's logical-axis spec tree of ``init_cache``' tree."""
    kv = ("none", "cache_batch", "kv_seq", "kv_heads", "head_dim")
    return {"self": {"k": kv, "v": kv}, "cross_k": kv, "cross_v": kv}


def layer_views(params):
    """Both stacks as per-layer views (``decoder.layer_views``): the silo
    round trains each layer as its own autograd leaf."""
    return decoder.layer_views(params, ("enc_blocks", "dec_blocks"))


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def encode(params, cfg, frames):
    """frames: [B, F, FRONTEND_DIM] -> the normed encoder output [B, F, d]
    in the compute dtype."""
    B, Fr, _ = frames.shape
    h = L.linear(frames.to(cfg.compute_dtype), params["enc_proj"])
    positions = _positions(B, Fr, h.device)
    for g in range(cfg.n_encoder_layers):
        bp = decoder.group(params["enc_blocks"], g)
        out, _ = L.attn_forward(bp["attn"], cfg, h, positions, causal=False)
        h = h + out
        h = h + L.ffn_forward(bp["ffn"], cfg, h)
    return L.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _cross_kv(bp, cfg, enc):
    """The cross-attention's K and V of the encoder output: [B, F, Hkv,
    hd] each."""
    B, Fr, _ = enc.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = L.linear(enc, bp["wk"]).reshape(B, Fr, hkv, hd)
    v = L.linear(enc, bp["wv"]).reshape(B, Fr, hkv, hd)
    return k, v


def _cross_attn(bp, cfg, x, ck, cv):
    """x: [B, T, d]; ck/cv: [B, F, Hkv, hd] (the encoder's projected K/V)."""
    B, T, _ = x.shape
    hq, hd = cfg.n_heads, cfg.resolved_head_dim
    h = L.rms_norm(x, bp["norm"], cfg.norm_eps)
    q = L.linear(h, bp["wq"]).reshape(B, T, hq, hd)
    out = L.attention_ref(q, ck, cv, causal=False)
    return L.linear(out.reshape(B, T, -1), bp["wo"])


def _self_cache(cfg, kv):
    """Prefill K/V [B, T, Hkv, hd] in the decode layout: padded with zeros
    or cut to ``max_decoder_len`` slots, in the compute dtype."""
    W = cfg.max_decoder_len
    return {n: F.pad(t.to(cfg.compute_dtype),
                     (0, 0, 0, 0, 0, max(0, W - t.shape[1])))[:, :W]
            for n, t in zip(("k", "v"), kv)}


def decoder_forward(params, cfg, tokens, enc, mode: str, cache=None,
                    cur_index=None):
    """tokens: [B, T]; enc: [B, F, d] (None in decode, which reads the
    cached cross K/V).  mode "train" returns (h, None); "prefill" and
    "decode" return (h, cache): per layer {"self": {"k", "v"} [B,
    max_decoder_len, Hkv, hd], "cross_k", "cross_v" [B, F, Hkv, hd]},
    stacked over the layers."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    B, T = tokens.shape
    h = L.embed_tokens(params["embeddings"], cfg, tokens)
    positions = None if mode == "decode" else _positions(B, T, h.device)
    caches = []
    for g in range(cfg.n_layers):
        bp = decoder.group(params["dec_blocks"], g)
        if mode == "decode":
            lcache = decoder.group(cache, g)
            out, new_self = L.attn_decode(bp["self"], cfg, h, lcache["self"],
                                          cur_index)
            ck, cv = lcache["cross_k"], lcache["cross_v"]
        else:
            out, kv = L.attn_forward(bp["self"], cfg, h, positions)
            new_self = None if mode == "train" else _self_cache(cfg, kv)
            ck, cv = _cross_kv(bp["cross"], cfg, enc)
        h = h + out
        h = h + _cross_attn(bp["cross"], cfg, h, ck, cv)
        h = h + L.ffn_forward(bp["ffn"], cfg, h)
        if mode != "train":
            caches.append({"self": new_self, "cross_k": ck, "cross_v": cv})
    if mode == "train":
        return h, None
    return h, _stack(caches)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def train_loss(params, cfg, batch):
    """batch: frames [B, F, FRONTEND_DIM], tokens and labels [B, T],
    optional mask [B, T] -> (loss, {"lm_loss"}): the masked mean
    next-token cross-entropy of the teacher-forced decoder, its chunks
    through the fused cross-entropy op."""
    enc = encode(params, cfg, batch["frames"])
    h, _ = decoder_forward(params, cfg, batch["tokens"], enc, "train")
    loss = L.chunked_lm_loss(params["embeddings"], cfg, h, batch["labels"],
                             batch.get("mask"), use_fused=True)
    return loss, {"lm_loss": loss}


def prefill(params, cfg, batch):
    """Encode the frames and run the decoder over the prompt tokens ->
    (logits [B, V] for the next position, the decode cache)."""
    enc = encode(params, cfg, batch["frames"])
    h, cache = decoder_forward(params, cfg, batch["tokens"], enc, "prefill")
    return L.logits_fn(params["embeddings"], cfg, h[:, -1]), cache


def decode_step(params, cfg, cache, tokens, cur_index):
    """tokens: [B, 1]; cur_index: tokens already in the cache (the token
    goes to self-attention slot min(cur_index, max_decoder_len - 1))."""
    h, cache = decoder_forward(params, cfg, tokens, None, "decode",
                               cache=cache, cur_index=int(cur_index))
    return L.logits_fn(params["embeddings"], cfg, h[:, -1]), cache


def init_cache(cfg, batch: int, enc_len: int, dec_len: int,
               device=None) -> Dict[str, Any]:
    """An empty decode cache: per decoder layer a self-attention K/V of
    ``dec_len`` slots and a cross K/V over ``enc_len`` frames, zeros in
    the compute dtype, stacked over the layers."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_layers
    zeros = lambda n: torch.zeros((G, batch, n, hkv, hd),
                                  dtype=cfg.compute_dtype, device=device)
    return {"self": {"k": zeros(dec_len), "v": zeros(dec_len)},
            "cross_k": zeros(enc_len), "cross_v": zeros(enc_len)}
