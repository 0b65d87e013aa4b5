"""Jamba-1.5-Large — Mamba+attention 1:7 interleave, 16-expert top-2 MoE
[arXiv:2403.19887]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_every=2,
    attn_period=8,                     # 1 attention layer per 8 (1:7)
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    attention="sliding_window", window_size=4096,  # on the attn layers
    citation="arXiv:2403.19887",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, attn_period=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, n_experts=4, experts_per_token=2,
    ssm_state=8, window_size=64, remat=False)
