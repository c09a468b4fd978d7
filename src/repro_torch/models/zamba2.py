"""Zamba2-style hybrid as an ``nn.Module``: a Mamba2 backbone and ONE
shared attention + SwiGLU block applied before every ``attn_every`` mamba
layers — the reference's ``models/zamba2.py``, training only (serving
waits for ROADMAP queue 1, item 7).

The layers nest: ``supers`` is a stack of ``n_layers // attn_every``
supers, each the shared block and then an ``inner`` stack of
``attn_every`` mamba layers (every ``supers.inner.*`` leaf has leading
axes (n_super, attn_every)); the ``n_layers % attn_every`` leftover mamba
layers form the ``tailb`` stack.  The shared block's parameters are re-used
by every super; its primitives are registered under ``shared/`` names, so
the clipping engines fold its use axis into the token axis and the
per-example norms are exact across uses.  The embedding, final norm,
head and loss are :class:`~.common.TokenLM`'s.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.tape import Tape, scan_blocks
from . import common as cm
from .mamba2 import MambaLayers, mamba_layer_body
from .transformer import _Attention, _SwiGLU


class _Shared(nn.Module):
    def __init__(self, cfg: ArchConfig, a: cm.AttnCfg, gen, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = cm.Leaf(torch.ones(d, device=device))
        self.attn = _Attention((), d, a, gen, device)
        self.ln2 = cm.Leaf(torch.ones(d, device=device))
        self.mlp = _SwiGLU((), d, cfg.d_ff, gen, device)


class _Supers(nn.Module):
    def __init__(self, n_super: int, cfg: ArchConfig, gen, device):
        super().__init__()
        self.inner = MambaLayers((n_super, cfg.attn_every), cfg, gen, device)


class Zamba2LM(cm.TokenLM):
    def _build(self, gen, device):
        cfg = self.cfg
        self.acfg = cm.AttnCfg(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta)
        self.n_super = cfg.n_layers // cfg.attn_every
        self.tail = cfg.n_layers - self.n_super * cfg.attn_every
        self.shared = _Shared(cfg, self.acfg, gen, device)
        self.supers = _Supers(self.n_super, cfg, gen, device)
        if self.tail:
            self.tailb = MambaLayers((self.tail,), cfg, gen, device)
        self._super_leaves = cm.leaf_names(self.supers)
        self._shared_leaves = cm.leaf_names(self.shared)
        self._tail_leaves = cm.leaf_names(self.tailb) if self.tail else ()

    def _shared_block(self, sub: Tape, sp: dict, x, positions):
        h = cm.rmsnorm(sub, "shared/ln1", x, cm.sub_params(sp, "ln1"),
                       path="shared.ln1")
        x = x + cm.self_attention(sub, "shared/attn", "shared.attn",
                                  cm.sub_params(sp, "attn"), h, self.acfg,
                                  positions=positions)
        h = cm.rmsnorm(sub, "shared/ln2", x, cm.sub_params(sp, "ln2"),
                       path="shared.ln2")
        return x + cm.swiglu(sub, "shared/mlp", "shared.mlp",
                             cm.sub_params(sp, "mlp"), h)

    def _layers(self, tape: Tape, tokens: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)
        sp = cm.stacked_leaves(self.shared, self._shared_leaves)
        inner = mamba_layer_body(cfg, "supers.inner")

        def super_body(sub, p, x):
            x = self._shared_block(sub, sp, x, positions)
            return scan_blocks(sub, "inner", inner, cm.sub_params(p, "inner"),
                               x, cfg.attn_every)

        x = scan_blocks(tape, "supers", super_body,
                        cm.stacked_leaves(self.supers, self._super_leaves), x,
                        self.n_super)
        if self.tail:
            x = scan_blocks(tape, "tailb", mamba_layer_body(cfg, "tailb"),
                            cm.stacked_leaves(self.tailb, self._tail_leaves),
                            x, self.tail)
        return x
