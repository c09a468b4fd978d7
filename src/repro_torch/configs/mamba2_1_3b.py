"""Mamba2-1.3B: attention-free SSD [arXiv:2405.21060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_chunk=64,
)
