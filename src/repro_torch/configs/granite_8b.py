"""Granite-8B-Code (llama-arch) [arXiv:2405.04324]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=49152,
    window_size=4096,  # used by the long_500k sliding-window variant
    citation="arXiv:2405.04324",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, window_size=64, remat=False)
