"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    head_dim=112,
    n_experts=384, experts_per_token=8, moe_every=1,
    window_size=4096,  # used by the long_500k sliding-window variant
    citation="arXiv:2501.kimi2",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64,
    head_dim=32, vocab_size=512, n_experts=4, experts_per_token=2,
    window_size=64, remat=False)
