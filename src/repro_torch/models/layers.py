"""Shared neural building blocks of the decoder LMs (plain functions over
params dicts), the port's copy of ``repro/models/layers.py``.

Params keep the reference's tree and layout, so reference params carry
across unchanged (``repro_torch.convert.params_from_reference``).  Every
``init_*`` returns the params dict alone; the reference's logical-axis
specs of each block are the ``*_SPECS`` tables beside it, which the
dry-run (``repro_torch.sharding``, ``launch.dryrun``) reads.  Every
matmul casts the weight to
the activation's dtype, as the reference does.  The LM loss
(``chunked_lm_loss``) walks the sequence in chunks so that the [B, S, V]
logits never exist at once; ``decoder.train_loss`` runs it through the
fused cross-entropy op.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None, device=None, stack: int = 0):
    """N(0, 1) * scale with scale = fan_in^-0.5 by default; ``stack`` > 0
    prepends a group axis of that size (the reference's vmapped init).
    Drawn in place, so a full-width leaf needs no second buffer."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    full = ((stack,) if stack else ()) + shape
    out = torch.empty(full, dtype=torch.float32, device=device)
    out.normal_(generator=generator).mul_(scale)
    return out.to(dtype)


def linear(x, w):
    """``x @ w`` with the weight cast to the activation's dtype, the
    reference's projection.  XLA (and cuBLAS on the card) accumulates a
    bfloat16 product in float32 and rounds it once; torch's CPU bfloat16
    matmul rounds elsewhere, so there the product of the cast operands is
    taken in float32 and rounded once."""
    w = w.to(x.dtype)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    return x @ w


class _SiLU(torch.autograd.Function):
    """``x * s``, ``s = 1 / (1 + exp(-x))``, with JAX's derivative of it:
    ``g * s + (g * x) * (s * (1 - s))`` (``lax.logistic``'s JVP).  The
    autograd of the forward's ops would divide ``exp(-x)`` by ``(1 +
    exp(-x))^2``, which is inf / inf = NaN once ``exp(-x)`` overflows
    (x below about -88 in float32), as an MoE expert's un-normalised
    input can reach."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        s = 1.0 / (1.0 + torch.exp(-x))
        return x * s, s

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1.0 - s))


def silu(x):
    """``x * sigmoid(x)`` with ``sigmoid(x) = 1 / (1 + exp(-x))`` as
    separate ops, which is how the reference's ``jax.nn.silu`` runs: in
    bfloat16 each step is rounded (``F.silu`` and ``torch.sigmoid`` round
    once and differ from it in ~1/3 of bf16 values).  Its backward is the
    reference's (``_SiLU``)."""
    return _SiLU.apply(x)[0]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps: float = 1e-5):
    """float32 inside, cast back to x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * gamma.to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, hd]; positions: [B, S] (absolute).  Rotates the two
    halves of the head dim (not interleaved pairs), as the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs   # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (plain path, with a validity mask over cache slots)
# ---------------------------------------------------------------------------


def _attn_one_chunk(q, k, v, q_pos, k_valid, causal, window):
    """q: [B, qc, Hq, hd]; k/v: [B, T, Hkv, hd]; q_pos: [B, qc];
    k_valid: [B, T] bool (False = padded/unwritten cache slot)."""
    B, qc, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, qc, Hkv, G, hd)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg.to(torch.float32),
                          k.to(torch.float32))
    scores = scores * hd ** -0.5
    k_pos = torch.arange(T, device=q.device)[None, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = k_valid[:, None, None, None, :]
    if causal:
        mask = mask & (k_pos <= qp)
    if window:
        mask = mask & (k_pos > qp - window)
    scores = torch.where(mask, scores,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(B, qc, Hq, hd)


def attention_ref(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
                  k_valid=None, q_chunk: int = 512):
    """Chunked multi-head attention with GQA, causal and sliding-window
    masks, and per-slot validity: the reference's plain path, which serves
    decode.  q: [B, S, Hq, hd]; k/v: [B, T, Hkv, hd]; ``q_offset`` is the
    absolute position of q[0] (int or [B])."""
    B, S = q.shape[:2]
    q_offset = torch.as_tensor(q_offset, device=q.device)
    if q_offset.dim() == 0:
        q_offset = q_offset.expand(B)
    if k_valid is None:
        k_valid = torch.ones((B, k.shape[1]), dtype=torch.bool,
                             device=q.device)
    positions = q_offset[:, None] + torch.arange(S, device=q.device)[None, :]
    outs = [_attn_one_chunk(q[:, c:c + q_chunk], k, v,
                            positions[:, c:c + q_chunk], k_valid, causal,
                            window) for c in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------


#: logical axes of an attention block's leaves (the reference's)
ATTN_SPECS = {
    "wq": ("fsdp", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "fsdp"),
    "norm": ("embed",),
}


def init_attention(generator, cfg, device=None, stack: int = 0):
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    dt = cfg.params_dtype
    mk = lambda shape, scale=None: dense_init(generator, shape, dt, scale,
                                              device, stack)
    return {
        "wq": mk((d, hq * hd)),
        "wk": mk((d, hkv * hd)),
        "wv": mk((d, hkv * hd)),
        "wo": mk((hq * hd, d), (hq * hd) ** -0.5),
        "norm": torch.ones(((stack,) if stack else ()) + (d,), dtype=dt,
                           device=device),
    }


def _qkv(params, cfg, x, positions):
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q = linear(h, params["wq"]).reshape(B, S, hq, hd)
    k = linear(h, params["wk"]).reshape(B, S, hkv, hd)
    v = linear(h, params["wv"]).reshape(B, S, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _window(cfg) -> int:
    return cfg.window_size if cfg.attention == "sliding_window" else 0


def attn_forward(params, cfg, x, positions, *, window: Optional[int] = None,
                 causal: bool = True):
    """Full-sequence (train / prefill) self-attention from position 0,
    through the differentiable flash-attention op (the kernels on a CUDA
    tensor, their plain versions on a CPU one).  Returns (out, (k, v))."""
    window = _window(cfg) if window is None else window
    if not causal:
        window = 0
    q, k, v = _qkv(params, cfg, x, positions)
    out = kops.flash_attention(q, k, v, causal, window)
    out = out.reshape(*x.shape[:2], -1)
    return linear(out, params["wo"]), (k, v)


def attn_decode(params, cfg, x, cache, cur_index: int):
    """Single-token decode.  cache: dict(k=[B, W, Hkv, hd], v=...).  For
    sliding-window archs W == window (ring buffer, slot cur % W); otherwise
    the token goes to slot min(cur, W - 1), so once the cache is full each
    new token overwrites the last slot, as in the reference."""
    B = x.shape[0]
    window = _window(cfg)
    cur_index = int(cur_index)
    positions = torch.full((B, 1), cur_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    W = cache["k"].shape[1]
    slot = cur_index % W if window else min(cur_index, W - 1)
    ck = cache["k"].clone()
    cv = cache["v"].clone()
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    valid = (torch.arange(W, device=x.device) < cur_index + 1)[None, :]
    # ring buffer: every live slot is inside the window by construction, so
    # positional masking is off and slot validity alone masks
    out = attention_ref(q, ck, cv, causal=False, window=0,
                        q_offset=positions[:, 0], k_valid=valid.expand(B, W))
    out = linear(out.reshape(B, 1, -1), params["wo"])
    return out, {"k": ck, "v": cv}


def attn_cache_init(cfg, batch: int, max_len: int, device=None):
    window = _window(cfg)
    W = min(window, max_len) if window else max_len
    shape = (batch, W, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------


#: logical axes of a SwiGLU FFN's leaves (the reference's)
FFN_SPECS = {
    "w_gate": ("fsdp", "ff"),
    "w_up": ("fsdp", "ff"),
    "w_down": ("ff", "fsdp"),
    "norm": ("embed",),
}


def init_ffn(generator, cfg, d_ff: Optional[int] = None, device=None,
             stack: int = 0):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.params_dtype
    mk = lambda shape, scale=None: dense_init(generator, shape, dt, scale,
                                              device, stack)
    return {
        "w_gate": mk((d, f)),
        "w_up": mk((d, f)),
        "w_down": mk((f, d), f ** -0.5),
        "norm": torch.ones(((stack,) if stack else ()) + (d,), dtype=dt,
                           device=device),
    }


def ffn_forward(params, cfg, x):
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    g = linear(h, params["w_gate"])
    u = linear(h, params["w_up"])
    return linear(silu(g) * u, params["w_down"])


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


#: logical axes of the embedding leaves (the reference's; a tied config
#: has no "unembed")
EMB_SPECS = {
    "tok": ("fsdp", "embed"),
    "unembed": ("fsdp", "vocab"),
    "final_norm": ("embed",),
}


def init_embeddings(generator, cfg, device=None):
    dt = cfg.params_dtype
    params = {
        "tok": dense_init(generator, (cfg.vocab_size, cfg.d_model), dt, 1.0,
                          device),
        "unembed": dense_init(generator, (cfg.d_model, cfg.vocab_size), dt,
                              None, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if cfg.tie_embeddings:
        del params["unembed"]
    return params


def embed_tokens(params, cfg, tokens):
    """Rows of the table, then cast: bitwise the reference's cast-then-
    gather, without a compute-dtype copy of the whole table."""
    return params["tok"][tokens.long()].to(cfg.compute_dtype)


def _unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["tok"].T.to(cfg.compute_dtype)
    return params["unembed"].to(cfg.compute_dtype)


def logits_fn(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return linear(h, _unembed_matrix(params, cfg))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_xent(logits, labels, mask=None):
    """Cross-entropy in float32, the reference's.  labels: int ids; mask:
    [..., S] bool (or 0/1) -> the masked mean ``sum / max(count, 1)``, or
    the plain mean without a mask."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - gold
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1)
    return loss.mean()


def chunked_lm_loss(params, cfg, h, labels, mask=None, chunk: int = 1024,
                    use_fused: bool = False):
    """Masked mean cross-entropy of the LM head over ``h`` [B, S, d],
    chunk by chunk along the sequence (the reference's ``lax.scan``
    becomes a loop), so only one chunk's logits exist at a time.  A length
    that ``chunk`` does not divide is one chunk of length S, as in the
    reference.  ``use_fused`` takes each chunk through the fused
    cross-entropy op (``kernels.ops.fused_softmax_xent``: the kernel on a
    CUDA tensor, its plain version, float32 product, on a CPU one), with
    the compute-dtype W cast once a loss into a ``[d, ceil8(V)]`` buffer
    (``kernels.ops.pitched``, one copy) so that any vocabulary takes the
    kernels' tensor-core route; otherwise the chunk's logits are the
    compute-dtype product, upcast."""
    B, S, d = h.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=h.device)
    n_chunks = max(1, S // chunk)
    if S % chunk:
        n_chunks, chunk = 1, S
    if use_fused:
        W = kops.pitched(params["tok"].T if cfg.tie_embeddings
                         else params["unembed"], cfg.compute_dtype)
    else:
        W = _unembed_matrix(params, cfg)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        hc = rms_norm(h[:, sl], params["final_norm"], cfg.norm_eps)
        lc, mc = labels[:, sl], mask[:, sl]
        if use_fused:
            losses = kops.fused_softmax_xent(
                hc.reshape(-1, d).contiguous(), W,
                lc.reshape(-1).to(torch.int32).contiguous()
            ).reshape(lc.shape)
        else:
            logits = linear(hc, W).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
            losses = lse - gold
        tot = tot + (losses * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1)
