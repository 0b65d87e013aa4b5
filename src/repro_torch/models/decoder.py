"""Decoder-only LM (dense attention, MoE, Mamba and hybrid stacks), the
port's copy of ``repro/models/decoder.py``: training loss, prefill and
decode.

Layers are ``n_groups`` repetitions of a ``period``-layer block pattern
(period 1 for uniform stacks).  Per-position params are stacked on a
leading group axis, as in the reference, and ``forward`` walks the groups
with a Python loop where the reference scans.  A block leaf may also be a
list of the G per-group tensors (``layer_views``): the silo round trains
those views of its stacked storage as separate autograd leaves, so that
no layer's backward fills a gradient the size of the whole stack.  With
``cfg.remat`` the training forward recomputes each group in the backward
pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
An MoE FFN (``models.moe``) adds its load-balance loss to the blocks'
``aux``, which the training loss weighs in.  A VLM config (``n_patches``)
prepends a batch's projected patch embeddings to its token embeddings
(``embed_inputs``): the training loss drops those positions, the prefill
cache keeps them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import check_ported
from repro_torch.models import layers as L
from repro_torch.models import mamba as Mb
from repro_torch.models import moe as Moe


def block_kinds(cfg, pos: int) -> Tuple[str, str]:
    """(mixer_kind, ffn_kind) for block position ``pos`` within a group."""
    mixer = "attn" if cfg.is_attn_layer(pos) else "mamba"
    if cfg.d_ff <= 0:
        ffn = "none"
    elif cfg.is_moe_layer(pos):
        ffn = "moe"
    else:
        ffn = "dense"
    return mixer, ffn


def n_groups(cfg) -> int:
    period = cfg.attn_period or 1
    if cfg.n_layers % period:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                         f"attn_period={period}")
    return cfg.n_layers // period


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_one_pos(generator, cfg, pos: int, device, G: int):
    mixer, ffn = block_kinds(cfg, pos)
    params: Dict[str, Any] = {}
    if mixer == "attn":
        params["mixer"] = L.init_attention(generator, cfg, device, stack=G)
    else:
        params["mixer"] = Mb.init_mamba(generator, cfg, device, stack=G)
    if ffn == "dense":
        params["ffn"] = L.init_ffn(generator, cfg, device=device, stack=G)
    elif ffn == "moe":
        params["ffn"] = Moe.init_moe(generator, cfg, device=device, stack=G)
    return params


def _lift(tree):
    """A spec tree of one block with the group axis ("none") prepended to
    every leaf: the specs of the stacked [G, ...] leaves."""
    if isinstance(tree, dict):
        return {k: _lift(v) for k, v in tree.items()}
    return ("none",) + tuple(tree)


def _pos_specs(cfg, pos: int):
    """Spec tree of one (unstacked) block position."""
    mixer, ffn = block_kinds(cfg, pos)
    specs: Dict[str, Any] = {
        "mixer": dict(L.ATTN_SPECS if mixer == "attn" else Mb.MAMBA_SPECS)}
    if ffn == "dense":
        specs["ffn"] = dict(L.FFN_SPECS)
    elif ffn == "moe":
        specs["ffn"] = dict(Moe.MOE_SPECS)
    return specs


def param_specs(cfg, extra_embed_dim: int = 0):
    """The reference's logical-axis spec tree of ``init_params``' tree:
    a tuple of axis names a leaf, the stacked block leaves led by
    "none"."""
    specs: Dict[str, Any] = {"embeddings": dict(L.EMB_SPECS)}
    if cfg.tie_embeddings:
        del specs["embeddings"]["unembed"]
    if extra_embed_dim:
        specs["modality_proj"] = ("none", "embed")
    specs["blocks"] = {f"pos{p}": _lift(_pos_specs(cfg, p))
                       for p in range(cfg.attn_period or 1)}
    return specs


def init_params(generator: torch.Generator, cfg, extra_embed_dim: int = 0,
                device=None):
    """Params on the generator's device (or on ``device``: "meta" builds
    the shapes and dtypes alone, ``models.api.abstract_params``),
    per-position leaves stacked over
    the groups: {"embeddings": {...}, "blocks": {"pos<p>": {"mixer",
    "ffn"}}}, plus "modality_proj" [extra_embed_dim, d] when
    ``extra_embed_dim`` (a VLM's patch projection): the reference's tree.
    Torch cannot reproduce the reference's threefry draws; parity runs
    hand its params in instead
    (``repro_torch.convert.params_from_reference``)."""
    check_ported(cfg)
    device = generator.device if device is None else torch.device(device)
    period = cfg.attn_period or 1
    G = n_groups(cfg)
    params: Dict[str, Any] = {
        "embeddings": L.init_embeddings(generator, cfg, device)}
    if extra_embed_dim:
        params["modality_proj"] = L.dense_init(
            generator, (extra_embed_dim, cfg.d_model), cfg.params_dtype,
            device=device)
    params["blocks"] = {f"pos{p}": _init_one_pos(generator, cfg, p, device,
                                                 G) for p in range(period)}
    return params


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _apply_block(pparams, cfg, pos, h, positions, mode, cache, cur_index):
    """One block: (h, the mixer's new cache, the MoE aux loss or 0)."""
    mixer, ffn = block_kinds(cfg, pos)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mixer == "attn":
        if mode == "decode":
            out, new_mixer_cache = L.attn_decode(
                pparams["mixer"], cfg, h, cache, cur_index)
        else:
            out, kv = L.attn_forward(pparams["mixer"], cfg, h, positions)
            new_mixer_cache = (None if mode == "train"
                               else _kv_to_cache(cfg, kv, positions))
    else:
        out, new_mixer_cache = Mb.mamba_forward(
            pparams["mixer"], cfg, h, cache=cache if mode == "decode" else None)
    h = h + out
    if ffn == "dense":
        h = h + L.ffn_forward(pparams["ffn"], cfg, h)
    elif ffn == "moe":
        out, aux = Moe.moe_forward(pparams["ffn"], cfg, h)
        h = h + out
    return h, new_mixer_cache, aux


def _kv_to_cache(cfg, kv, positions):
    """Full-sequence prefill K/V in the decode cache layout: S slots, or
    the trailing window of a sliding-window arch aligned so that slot =
    pos % W."""
    k, v = kv
    window = cfg.window_size if cfg.attention == "sliding_window" else 0
    S = k.shape[1]
    if window and S > window:
        k, v = k[:, -window:], v[:, -window:]
        # prefill's positions run from 0, so the first kept one is S - W
        # (read from the shape: a meta trace has no values to read)
        S0 = positions.shape[1] - window
        roll = S0 % window
        k = torch.roll(k, roll, dims=1)
        v = torch.roll(v, roll, dims=1)
    return {"k": k.to(cfg.compute_dtype), "v": v.to(cfg.compute_dtype)}


def _cache_init_pos(cfg, pos: int, batch: int, max_len: int, device):
    mixer, _ = block_kinds(cfg, pos)
    if mixer == "attn":
        return L.attn_cache_init(cfg, batch, max_len, device)
    return Mb.mamba_cache_init(cfg, batch, device=device)


def init_cache(cfg, batch: int, max_len: int, device=None):
    """Stacked decode cache: {pos<p>: cache stacked over groups}."""
    period = cfg.attn_period or 1
    G = n_groups(cfg)
    return {f"pos{p}": {k: t[None].expand((G,) + t.shape).contiguous()
                        for k, t in _cache_init_pos(cfg, p, batch, max_len,
                                                    device).items()}
            for p in range(period)}


def cache_specs(cfg):
    """The reference's logical-axis spec tree of ``init_cache``' tree."""
    out = {}
    for p in range(cfg.attn_period or 1):
        mixer, _ = block_kinds(cfg, p)
        if mixer == "attn":
            kv = ("none", "cache_batch", "kv_seq", "kv_heads", "head_dim")
            out[f"pos{p}"] = {"k": kv, "v": kv}
        else:
            out[f"pos{p}"] = {
                "conv": ("none", "cache_batch", "none", "ssm_inner"),
                "ssm": ("none", "cache_batch", "ssm_inner", "ssm_state")}
    return out


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def group(tree, g: int):
    """Group ``g`` of a params or cache tree: row g of each stacked leaf,
    or element g of a per-group list (``layer_views``)."""
    if isinstance(tree, dict):
        return {k: group(v, g) for k, v in tree.items()}
    return tree[g]


def layer_views(params, stacked=("blocks",)):
    """The params tree with every leaf ([G, ...]) under the ``stacked``
    keys replaced by the list of its G rows, views of the same storage.
    Training these rows as separate autograd leaves gives each layer a
    gradient of its own size; the stacked leaf would give every layer's
    backward a zero-filled gradient of the whole stack."""
    def rows(tree):
        if isinstance(tree, dict):
            return {k: rows(v) for k, v in tree.items()}
        return list(tree.unbind(0))
    return {k: (rows(v) if k in stacked else v) for k, v in params.items()}


def _train_forward(params, cfg, h, positions):
    """Training pass: (h, aux summed over the blocks), no cache; with
    ``cfg.remat`` (and a gradient wanted) each group is recomputed in the
    backward pass, its aux too."""
    period = cfg.attn_period or 1

    def group_body(h, aux, gparams):
        for p in range(period):
            h, _, a = _apply_block(gparams[f"pos{p}"], cfg, p, h, positions,
                                   "train", None, None)
            aux = aux + a
        return h, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(n_groups(cfg)):
        gparams = group(params["blocks"], g)
        if remat:
            h, aux = checkpoint(group_body, h, aux, gparams,
                                use_reentrant=False)
        else:
            h, aux = group_body(h, aux, gparams)
    return h, aux


def forward(params, cfg, h, positions, mode: str, cache=None, cur_index=None):
    """h: [B, S, d] embeddings.  Returns (h_out, new_cache, aux_loss).

    mode: "train" (no cache: new_cache is None), "prefill" (cache emitted)
    or "decode" (cache consumed and updated; S == 1).  aux_loss sums the
    MoE blocks' load-balance losses (0 without MoE)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "train":
        h, aux = _train_forward(params, cfg, h, positions)
        return h, None, aux
    period = cfg.attn_period or 1
    new_cache: Dict[str, Dict[str, torch.Tensor]] = {
        f"pos{p}": {} for p in range(period)}
    G = n_groups(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(G):
        for p in range(period):
            key = f"pos{p}"
            pc = None if cache is None else group(cache[key], g)
            h, nc, a = _apply_block(group(params["blocks"][key], g), cfg, p,
                                    h, positions, mode, pc, cur_index)
            aux = aux + a
            for name, t in nc.items():
                if name not in new_cache[key]:
                    new_cache[key][name] = torch.empty(
                        (G,) + tuple(t.shape), dtype=t.dtype, device=t.device)
                new_cache[key][name][g] = t
    return h, new_cache, aux


# ---------------------------------------------------------------------------
# public model surface (used by api.Model)
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg, batch):
    """Input embeddings from a batch dict: the tokens' rows [B, T, d], and
    for a VLM config with ``batch["patches"]`` [B, P, F] the patches
    projected by ``modality_proj`` in the compute dtype before them, [B,
    P + T, d].  A VLM batch without patches embeds its tokens alone (the
    token-only batches of the silo CLI and of ``from_model``)."""
    h = L.embed_tokens(params["embeddings"], cfg, batch["tokens"])
    if cfg.n_patches and "patches" in batch:
        pre = L.linear(batch["patches"].to(cfg.compute_dtype),
                       params["modality_proj"])
        h = torch.cat([pre, h], dim=1)
    return h


def train_loss(params, cfg, batch):
    """batch: tokens [B, S], labels [B, S], optional mask [B, S] (bool),
    and for a VLM optional patches [B, P, F] -> (loss, {"lm_loss",
    "aux_loss"}): the masked mean next-token cross-entropy over the token
    positions (the P patch positions dropped), its chunks through the
    fused cross-entropy op (the kernel on a CUDA tensor, its plain version
    on a CPU one), plus ``0.01 * aux / n_layers`` for an MoE config (aux:
    the blocks' summed load-balance losses).  As in the reference,
    "lm_loss" is that total and "aux_loss" the summed aux."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    h = embed_inputs(params, cfg, batch)
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    h, _, aux = forward(params, cfg, h, positions, "train")
    if cfg.n_patches and "patches" in batch:
        h = h[:, batch["patches"].shape[1]:]
    loss = L.chunked_lm_loss(params["embeddings"], cfg, h, batch["labels"],
                             batch.get("mask"), use_fused=True)
    if cfg.n_experts:
        loss = loss + 0.01 * aux / max(1, cfg.n_layers)
    return loss, {"lm_loss": loss, "aux_loss": aux}


def prefill(params, cfg, batch):
    """batch["tokens"]: [B, S] (and a VLM's patches [B, P, F]) -> (logits
    [B, V] for the next position, cache with S (P + S) slots per attention
    layer)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    h = embed_inputs(params, cfg, batch)
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    h, cache, _ = forward(params, cfg, h, positions, "prefill")
    return L.logits_fn(params["embeddings"], cfg, h[:, -1]), cache


def decode_step(params, cfg, cache, tokens, cur_index):
    """tokens: [B, 1]; cur_index: tokens already in the cache."""
    h = L.embed_tokens(params["embeddings"], cfg, tokens)
    h, cache, _ = forward(params, cfg, h, None, "decode", cache,
                          int(cur_index))
    return L.logits_fn(params["embeddings"], cfg, h[:, -1]), cache
