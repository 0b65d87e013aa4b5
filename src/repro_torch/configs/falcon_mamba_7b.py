"""Falcon-Mamba-7B — attention-free Mamba-1 [arXiv:2410.05355]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    citation="arXiv:2410.05355",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, vocab_size=512, ssm_state=8, remat=False)
