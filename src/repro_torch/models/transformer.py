"""Dense decoder-only LM as an ``nn.Module``: llama-style (deepseek-67b,
llama3.2-3b), qwen2 (QKV bias), qwen3 (qk-norm), with optional
sliding-window attention — the reference's ``models/transformer.py``
``DenseLM``, training only (serving's cache, decode and prefill are not
ported yet: ROADMAP queue 1, item 7).

Parameter names are the reference's ``param_path`` strings (``emb.w``,
``blocks.attn.wq.w``, ``blocks.mlp.w1.w``, ``lnf.w``, ``head.w``).  The
blocks keep the reference's stacked layout: every ``blocks.*`` leaf has a
leading ``n_layers`` axis, unbound once per forward and looped in Python
(:func:`~repro_torch.core.tape.scan_blocks`, under tape scope ``blocks``).
The embedding, final norm, head and loss are :class:`~.common.TokenLM`'s.
Every parameterised op goes through a tape primitive, as in the reference:
``emb`` is ``embed``, each RMSNorm (and qk-norm) a ``scale``, every
projection and the head a ``dense``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.tape import Tape, scan_blocks
from . import common as cm


class _Attention(nn.Module):
    def __init__(self, lead, d, a: cm.AttnCfg, gen, device):
        super().__init__()
        hd = a.head_dim
        self.wq = cm.Dense(lead + (d, a.n_heads * hd), a.qkv_bias, gen, device)
        self.wk = cm.Dense(lead + (d, a.n_kv_heads * hd), a.qkv_bias, gen,
                           device)
        self.wv = cm.Dense(lead + (d, a.n_kv_heads * hd), a.qkv_bias, gen,
                           device)
        self.wo = cm.Dense(lead + (a.n_heads * hd, d), False, gen, device)
        if a.qk_norm:
            self.qn = cm.Leaf(torch.ones(lead + (hd,), device=device))
            self.kn = cm.Leaf(torch.ones(lead + (hd,), device=device))


class _SwiGLU(nn.Module):
    def __init__(self, lead, d, d_ff, gen, device):
        super().__init__()
        self.w1 = cm.Dense(lead + (d, d_ff), False, gen, device)
        self.w3 = cm.Dense(lead + (d, d_ff), False, gen, device)
        self.w2 = cm.Dense(lead + (d_ff, d), False, gen, device)


class _Blocks(nn.Module):
    """The n_layers decoder blocks, each leaf stacked on axis 0."""

    def __init__(self, cfg: ArchConfig, a: cm.AttnCfg, gen, device):
        super().__init__()
        lead, d = (cfg.n_layers,), cfg.d_model
        self.ln1 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.attn = _Attention(lead, d, a, gen, device)
        self.ln2 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.mlp = _SwiGLU(lead, d, cfg.d_ff, gen, device)


class DenseLM(cm.TokenLM):
    def _build(self, gen, device):
        cfg = self.cfg
        self.acfg = cm.AttnCfg(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window)
        self.blocks = _Blocks(cfg, self.acfg, gen, device)
        self._block_leaves = cm.leaf_names(self.blocks)

    def _layers(self, tape: Tape, tokens: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)

        def body(sub, p, x):
            h = cm.rmsnorm(sub, "ln1", x, cm.sub_params(p, "ln1"),
                           path="blocks.ln1")
            x = x + cm.self_attention(sub, "attn", "blocks.attn",
                                      cm.sub_params(p, "attn"), h, self.acfg,
                                      positions=positions)
            h = cm.rmsnorm(sub, "ln2", x, cm.sub_params(p, "ln2"),
                           path="blocks.ln2")
            return x + cm.swiglu(sub, "mlp", "blocks.mlp",
                                 cm.sub_params(p, "mlp"), h)

        return scan_blocks(tape, "blocks", body,
                           cm.stacked_leaves(self.blocks, self._block_leaves),
                           x, self.cfg.n_layers)
