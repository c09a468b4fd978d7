"""Llama-3.2-Vision 90B-class backbone: 100 layers, cross-attn image layers
every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision]. Vision encoder is a
stub (precomputed patch embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, rope_theta=5e5,
    cross_every=5, n_image_tokens=1601, frontend_dim=1280,
)
