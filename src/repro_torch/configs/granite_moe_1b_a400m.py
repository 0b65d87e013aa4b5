"""Granite-3.0-1B-A400M — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    n_experts=32, experts_per_token=8, moe_every=1,
    window_size=4096,  # used by the long_500k sliding-window variant
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=512, n_experts=4, experts_per_token=2, window_size=64,
    remat=False)
