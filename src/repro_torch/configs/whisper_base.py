"""Whisper-base backbone: 6L enc + 6L dec, conv frontend stubbed
[arXiv:2212.04356]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, n_encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, n_audio_frames=1500,
)
