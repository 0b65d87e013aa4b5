"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    window_size=4096,  # used by the long_500k sliding-window variant
    rope_theta=500000.0,
    citation="hf:meta-llama/Llama-3.2-1B",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, d_ff=384,
    vocab_size=512, window_size=64, remat=False)
