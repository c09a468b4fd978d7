"""DeepSeek-V2-Lite 16B: MLA (kv_lora=512) + MoE (2 shared + 64 routed,
top-6) [arXiv:2405.04434], as in the reference package (64 routed
experts)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, moe_d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2,
    kv_lora=512, rope_dim=64, head_dim=128,
    first_dense_layers=1, dense_d_ff=10944,
)
