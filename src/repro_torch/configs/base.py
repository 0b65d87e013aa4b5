"""Configuration system of the port: architecture and input-shape configs.

The port's own copy of ``repro/configs/base.py``: the same ``ArchConfig``
fields and defaults, with torch dtypes behind ``compute_dtype`` and
``params_dtype``.  ``get_config`` resolves every architecture id of the
reference (``PORTED_ARCHS``: all ten); ``check_ported`` refuses the config
field values the port does not honour with a ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture hyperparameters for one model family member."""

    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio | mclr | lstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1          # apply MoE FFN every k-th layer (1 = all layers)
    capacity_factor: float = 1.25

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0        # 0 -> ceil(d_model / 16)

    # --- hybrid (jamba): one attention layer per `attn_period` layers ---
    attn_period: int = 0        # 0 -> not hybrid

    # --- attention flavour ---
    attention: str = "full"     # full | sliding_window
    window_size: int = 4096

    # --- encoder-decoder (whisper-style) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_decoder_len: int = 448

    # --- VLM ---
    n_patches: int = 0          # >0 -> expects patch-embedding prefix

    # --- numerics ---
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    tie_embeddings: bool = False

    # --- runtime switches (kept for config parity; the port routes every
    # kernel by device, so use_pallas is not read; remat recomputes each
    # layer group in the training backward, torch.utils.checkpoint) ---
    use_pallas: bool = False
    remat: bool = True
    ssm_scan: str = "chunked"
    ssm_input_dtype: str = "float32"
    ssm_chunk: int = 256
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.n_experts <= 0:
            return False
        return (layer_idx % self.moe_every) == (self.moe_every - 1)

    def is_attn_layer(self, layer_idx: int) -> bool:
        """For hybrid archs: attention once per attn_period; else per family."""
        if self.family == "ssm":
            return False
        if self.attn_period:
            return (layer_idx % self.attn_period) == (self.attn_period - 1)
        return True


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: every architecture id of the reference, each with a config module here
ARCH_IDS = ("minitron-8b", "granite-moe-1b-a400m", "internvl2-2b",
            "mistral-large-123b", "whisper-tiny", "llama3.2-3b",
            "granite-8b", "kimi-k2-1t-a32b", "falcon-mamba-7b",
            "jamba-1.5-large-398b")
#: the ids the port serves: all of them
PORTED_ARCHS = ARCH_IDS


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    """Resolve ``--arch <id>`` to its config (or reduced smoke variant)."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def check_ported(cfg: ArchConfig) -> None:
    """Raise a ``ValueError`` for every field value of ``cfg`` the port
    does not implement.  Every architecture field is ported; the
    selective-scan options are accepted as the reference defines them:
    its sequential route is the function the port's scan computes on
    every device, and ``ssm_input_dtype`` feeds only the reference's
    chunked route (ROADMAP §C), so the port's scan takes float32 inputs
    under either value."""
    unported = []
    if cfg.ssm_scan not in ("chunked", "sequential"):
        unported.append(f"ssm_scan={cfg.ssm_scan!r} (chunked or "
                        "sequential)")
    if cfg.ssm_input_dtype not in ("float32", "bfloat16"):
        unported.append(f"ssm_input_dtype={cfg.ssm_input_dtype!r} "
                        "(float32 or bfloat16)")
    if cfg.dtype not in ("bfloat16", "float32") or cfg.param_dtype not in (
            "bfloat16", "float32"):
        unported.append(f"dtype={cfg.dtype!r}/param_dtype="
                        f"{cfg.param_dtype!r} (bfloat16 or float32)")
    if unported:
        raise ValueError(f"{cfg.name}: not ported: " + "; ".join(unported))
