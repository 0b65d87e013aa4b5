"""InternVL2-2B — InternViT frontend (stub) + InternLM2 backbone
[arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    n_patches=1024,
    window_size=4096,  # used by the long_500k sliding-window variant
    citation="arXiv:2404.16821",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, n_patches=16, window_size=64, remat=False)
