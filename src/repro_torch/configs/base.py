"""ArchConfig: the architecture description the port shares with the
reference package, as a plain dataclass (no JAX).

The port builds every family of the reference: the ViT, the dense decoder
LM, Mamba2, the Zamba2 hybrid, the MoE family (OLMoE, DeepSeek-V2 with
MLA), the Whisper encoder-decoder and the cross-attention VLM; a config
reads the same on both sides and ``reduced()`` gives the same smoke
variant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio | vit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    # MLA
    kv_lora: int = 0
    rope_dim: int = 0
    # SSM
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid
    attn_every: int = 0
    # vlm
    cross_every: int = 0
    n_image_tokens: int = 0
    frontend_dim: int = 0
    # audio
    n_audio_frames: int = 0
    n_encoder_layers: int = 0
    # vit (paper's model)
    image_size: int = 0
    patch: int = 16
    n_classes: int = 0
    # numerics
    dtype: str = "bfloat16"
    remat: bool = False
    ce_chunk: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:           # ssm
        return self.ssm_expand * self.d_model

    @property
    def nheads_ssm(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    def reduced(self, **over) -> "ArchConfig":
        """Smoke-test variant: same family/feature set, tiny dims (the
        reference's ``reduced()`` field for field)."""
        small = dict(
            n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256, vocab=97, head_dim=32,
            n_experts=4 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            first_dense_layers=min(self.first_dense_layers, 1),
            kv_lora=32 if self.kv_lora else 0,
            rope_dim=16 if self.rope_dim else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_every=1 if self.attn_every else 0,
            cross_every=2 if self.cross_every else 0,
            n_image_tokens=8 if self.n_image_tokens else 0,
            frontend_dim=48 if self.frontend_dim else 0,
            n_audio_frames=12 if self.n_audio_frames else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            image_size=32 if self.image_size else 0, patch=8,
            sliding_window=16 if self.sliding_window else 0,
            dtype="float32",
            name=self.name + "-smoke",
        )
        small.update(over)
        return dataclasses.replace(self, **small)
