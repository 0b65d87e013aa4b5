"""Minitron-8B — width-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    window_size=4096,  # used by the long_500k sliding-window variant
    citation="arXiv:2407.14679",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, window_size=64, remat=False)
