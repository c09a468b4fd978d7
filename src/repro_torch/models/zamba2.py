"""Zamba2-style hybrid as an ``nn.Module``: a Mamba2 backbone and ONE
shared attention + SwiGLU block applied before every ``attn_every`` mamba
layers — the reference's ``models/zamba2.py``, training and serving (the
decode cache, ``decode_step`` and chunked ``prefill_step``).

The layers nest: ``supers`` is a stack of ``n_layers // attn_every``
supers, each the shared block and then an ``inner`` stack of
``attn_every`` mamba layers (every ``supers.inner.*`` leaf has leading
axes (n_super, attn_every)); the ``n_layers % attn_every`` leftover mamba
layers form the ``tailb`` stack.  The shared block's parameters are re-used
by every super; its primitives are registered under ``shared/`` names, so
the clipping engines fold its use axis into the token axis and the
per-example norms are exact across uses.  The embedding, final norm,
head and loss are :class:`~.common.TokenLM`'s.

The decode cache is the reference's: ``attn``, one K/V cache per super
(n_super, B, S, Hkv, Dh), which each application of the shared block
writes in its own slice; ``supers``, the inner layers' mamba state and
conv (leading axes (n_super, attn_every)); ``tailb``, the tail's.  The
K/V rows are indexed by position, the mamba leaves accumulate (see
:mod:`.mamba2`), so the serving pool resets a reused slot and refuses
prefix sharing.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.tape import Tape, scan_blocks
from . import common as cm
from .mamba2 import (MambaLayers, mamba_cache, mamba_decode_body,
                     mamba_layer_body)
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


class Zamba2LM(cm.DecodeSteps, cm.TokenLM):
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

    # -- serving ------------------------------------------------------------
    def init_cache(self, params: Dict[str, torch.Tensor], B: int, S: int,
                   dtype=torch.bfloat16) -> dict:
        """Zero caches of ``B`` slots on the params' device: {"attn": {"k",
        "v"} (n_super, B, S, Hkv, Dh), "supers": the mamba caches with
        leading axes (n_super, attn_every), "tailb": the tail's (n_tail,)}
        (:func:`~.mamba2.mamba_cache`; the state in f32)."""
        cfg, dev = self.cfg, params["emb.w"].device
        kv = cm.init_attn_cache(B, S, self.acfg, dtype, device=dev)
        cache = {"attn": {n: v.new_zeros((self.n_super,) + v.shape)
                          for n, v in kv.items()},
                 "supers": mamba_cache((self.n_super, cfg.attn_every), B,
                                       cfg, dtype, dev)}
        if self.tail:
            cache["tailb"] = mamba_cache((self.tail,), B, cfg, dtype, dev)
        return cache

    def _decode_layers(self, params, cache, x, pos, valid):
        cfg = self.cfg
        pos = cm.decode_positions(pos, x.shape[0], x.device)
        sp = cm.sub_params(params, "shared")
        inner = mamba_decode_body(cfg, valid)
        # each super reads its inner stack's leaves and caches and its own
        # slice of the shared block's K/V cache
        stacked = cm.sub_params(params, "supers")
        stacked.update({f"inner.cache.{n}": c
                        for n, c in cache["supers"].items()})
        stacked.update({f"attn.{n}": c for n, c in cache["attn"].items()})

        def super_body(sub, p, x):
            h = cm.rmsnorm(sub, "ln1", x, cm.sub_params(sp, "ln1"), path="-")
            x = x + cm.decode_attention(sub, "attn", "-",
                                        cm.sub_params(sp, "attn"), h,
                                        self.acfg, cm.sub_params(p, "attn"),
                                        pos, valid)
            h = cm.rmsnorm(sub, "ln2", x, cm.sub_params(sp, "ln2"), path="-")
            x = x + cm.swiglu(sub, "mlp", "-", cm.sub_params(sp, "mlp"), h)
            return scan_blocks(sub, "inner", inner, cm.sub_params(p, "inner"),
                               x, cfg.attn_every)

        x = scan_blocks(Tape(), "supers", super_body, stacked, x,
                        self.n_super)
        if self.tail:
            x = scan_blocks(Tape(), "tailb", inner,
                            cm.with_cache(params, "tailb", cache["tailb"]),
                            x, self.tail)
        return x
