"""Whisper-tiny — enc-dec with stub mel+conv frontend [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    is_encoder_decoder=True, n_encoder_layers=4, max_decoder_len=448,
    rope_theta=10000.0,
    citation="arXiv:2212.04356",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512, max_decoder_len=32, remat=False)
