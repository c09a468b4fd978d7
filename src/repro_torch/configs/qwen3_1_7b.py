"""Qwen3-1.7B: qk-norm, GQA [hf:Qwen/Qwen3-8B].  ``SLIDING`` is its
sliding-window variant (window=4096), as in the reference package."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, qk_norm=True, head_dim=128, rope_theta=1e6,
)

SLIDING = CONFIG.__class__(**{**CONFIG.__dict__, "sliding_window": 4096,
                              "name": "qwen3-1.7b-swa"})
