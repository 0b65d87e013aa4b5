"""Mistral-Large-Instruct-2407 (123B dense)
[hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab_size=32768,
    window_size=4096,  # used by the long_500k sliding-window variant
    rope_theta=1000000.0,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512, window_size=64, remat=False)
