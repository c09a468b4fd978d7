"""Llama-3.2-Vision-style VLM as an ``nn.Module``: a dense decoder with a
gated cross-attention layer every ``cross_every`` layers — the reference's
``models/vlm.py`` ``VisionLM``, training only (serving waits for ROADMAP
queue 1, item 7).

The ViT/SigLIP vision encoder and adapter are a stub, as in the reference:
``batch["frontend"]`` carries precomputed patch embeddings (B,
n_image_tokens, frontend_dim), and ``proj`` maps them to ``d_model``.

The layers nest: ``supers`` is a stack of ``n_layers // cross_every``
supers, each a ``selfb`` stack of ``cross_every - 1`` RoPE self-attention
SwiGLU layers (every ``supers.selfb.*`` leaf has leading axes (n_super,
self_per)) and then one ``crossb`` layer (leading axis (n_super,)): RMSNorm,
cross attention against the projected image tokens, a gate, RMSNorm and
SwiGLU.  The gate is one learnable scalar per super (``supers.crossb.gate.w``,
a 0-d ``scale`` in each super), initialised to 0 as in the reference, so
the cross-attention and ``proj`` gradients are exactly zero at init.  The
embedding, ``lnf`` (RMSNorm) and ``head`` frame the stack.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core import layers as L
from ..core.tape import Tape, scan_blocks
from . import common as cm
from .transformer import _Attention, _SwiGLU


class _SelfBlocks(nn.Module):
    def __init__(self, lead, cfg: ArchConfig, a: cm.AttnCfg, gen, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.attn = _Attention(lead, d, a, gen, device)
        self.ln2 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.mlp = _SwiGLU(lead, d, cfg.d_ff, gen, device)


class _CrossBlocks(nn.Module):
    def __init__(self, lead, cfg: ArchConfig, a: cm.AttnCfg, gen, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.xattn = _Attention(lead, d, a, gen, device)
        self.gate = cm.Leaf(torch.zeros(lead, device=device))
        self.ln2 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.mlp = _SwiGLU(lead, d, cfg.d_ff, gen, device)


class _Supers(nn.Module):
    def __init__(self, n_super: int, self_per: int, cfg: ArchConfig,
                 acfg: cm.AttnCfg, xacfg: cm.AttnCfg, gen, device):
        super().__init__()
        self.selfb = _SelfBlocks((n_super, self_per), cfg, acfg, gen, device)
        self.crossb = _CrossBlocks((n_super,), cfg, xacfg, gen, device)


class VisionLM(cm.FrontendLM):
    def __init__(self, cfg: ArchConfig, *, device, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.acfg = cm.AttnCfg(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta)
        self.xacfg = cm.AttnCfg(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            use_rope=False, causal=False)
        self.n_super = cfg.n_layers // cfg.cross_every
        self.self_per = cfg.cross_every - 1
        gen = torch.Generator(device=device).manual_seed(seed)
        d = cfg.d_model
        self.emb = cm.Leaf(torch.randn(cfg.vocab, d, generator=gen,
                                       device=device) * 0.02)
        self.proj = cm.Dense((cfg.frontend_dim, d), False, gen, device)
        self.supers = _Supers(self.n_super, self.self_per, cfg, self.acfg,
                              self.xacfg, gen, device)
        self.lnf = cm.Leaf(torch.ones(d, device=device))
        self.head = cm.Dense((d, cfg.vocab), False, gen, device)
        self._super_leaves = cm.leaf_names(self.supers)

    def _cross_block(self, sub: Tape, p: dict, x: torch.Tensor,
                     img: torch.Tensor) -> torch.Tensor:
        h = cm.rmsnorm(sub, "xln1", x, cm.sub_params(p, "ln1"),
                       path="supers.crossb.ln1")
        a = cm.cross_attention(sub, "xattn", "supers.crossb.xattn",
                               cm.sub_params(p, "xattn"), h, img, self.xacfg)
        a = L.scale(sub, "gate", a, p["gate.w"],
                    param_path="supers.crossb.gate.w")
        x = x + a
        h = cm.rmsnorm(sub, "xln2", x, cm.sub_params(p, "ln2"),
                       path="supers.crossb.ln2")
        return x + cm.swiglu(sub, "xmlp", "supers.crossb.mlp",
                             cm.sub_params(p, "mlp"), h)

    def backbone(self, tokens: torch.Tensor, frontend: torch.Tensor,
                 tape: Tape) -> torch.Tensor:
        """(B, T) text tokens and the patch embeddings -> (B, T, d)
        hidden states (after ``lnf``)."""
        dt = self.cfg.act_dtype
        img = L.dense(tape, "proj", frontend.to(dt), self.proj.w,
                      param_path="proj")
        x = L.embed(tape, "emb", tokens, self.emb.w, param_path="emb.w")
        x = x.to(dt)
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)

        def self_body(sub, p, x):
            h = cm.rmsnorm(sub, "ln1", x, cm.sub_params(p, "ln1"),
                           path="supers.selfb.ln1")
            x = x + cm.self_attention(sub, "attn", "supers.selfb.attn",
                                      cm.sub_params(p, "attn"), h, self.acfg,
                                      positions=positions)
            h = cm.rmsnorm(sub, "ln2", x, cm.sub_params(p, "ln2"),
                           path="supers.selfb.ln2")
            return x + cm.swiglu(sub, "mlp", "supers.selfb.mlp",
                                 cm.sub_params(p, "mlp"), h)

        def super_body(sub, p, x):
            x = scan_blocks(sub, "selfb", self_body,
                            cm.sub_params(p, "selfb"), x, self.self_per)
            return self._cross_block(sub, cm.sub_params(p, "crossb"), x, img)

        x = scan_blocks(tape, "supers", super_body,
                        cm.stacked_leaves(self.supers, self._super_leaves), x,
                        self.n_super)
        return cm.rmsnorm(tape, "lnf", x, {"w": self.lnf.w}, path="lnf")
