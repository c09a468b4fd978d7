"""Whisper-style encoder-decoder transformer as an ``nn.Module`` — the
reference's ``models/whisper.py`` ``WhisperLM``, training only (serving's
cache, decode and prefill wait for ROADMAP queue 1, item 7).

The mel-spectrogram and conv feature extractor is a stub, as in the
reference: ``batch["frontend"]`` carries precomputed frame embeddings
(B, frames, d_model).  Positions are sinusoidal in both stacks.

Parameter names are the reference's ``param_path`` strings: ``emb.w``,
``enc_blocks.*`` (a leading ``n_encoder_layers`` axis), ``enc_lnf``,
``dec_blocks.*`` (a leading ``n_layers`` axis), ``dec_lnf`` and ``head.w``.
Every norm is a layernorm (gain ``g.w`` and bias ``b.w``), the MLPs are
GELU with biases, ``wq``/``wk``/``wv`` carry biases and ``wo`` does not.
The encoder's attention is bidirectional; each decoder layer runs causal
self attention, then cross attention whose keys and values are projected
from the encoder's output (every decoder layer's ``xattn.wk``/``wv``
records that one tensor, shared, not copied).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core import layers as L
from ..core.tape import Tape, scan_blocks
from . import common as cm
from .transformer import _Attention
from .vit import _GeluMLP, _LayerNorm


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """positions (..., T) -> (..., T, dim) f32 sin/cos table, the
    reference's arithmetic: ``freq = exp(-log(10⁴) · i / (dim/2 - 1))``
    (product, then quotient, in f32) and ``[sin(p·freq), cos(p·freq)]``."""
    half = dim // 2
    dev = positions.device
    neg_log = -torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=dev))
    freq = torch.exp(neg_log * torch.arange(half, dtype=torch.float32,
                                            device=dev) / max(half - 1, 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _EncBlocks(nn.Module):
    def __init__(self, n: int, cfg: ArchConfig, a: cm.AttnCfg, gen, device):
        super().__init__()
        lead, d = (n,), cfg.d_model
        self.ln1 = _LayerNorm(lead + (d,), device)
        self.attn = _Attention(lead, d, a, gen, device)
        self.ln2 = _LayerNorm(lead + (d,), device)
        self.mlp = _GeluMLP(lead, d, cfg.d_ff, gen, device)


class _DecBlocks(nn.Module):
    def __init__(self, cfg: ArchConfig, a: cm.AttnCfg, gen, device):
        super().__init__()
        lead, d = (cfg.n_layers,), cfg.d_model
        self.ln1 = _LayerNorm(lead + (d,), device)
        self.attn = _Attention(lead, d, a, gen, device)
        self.lnx = _LayerNorm(lead + (d,), device)
        self.xattn = _Attention(lead, d, a, gen, device)
        self.ln2 = _LayerNorm(lead + (d,), device)
        self.mlp = _GeluMLP(lead, d, cfg.d_ff, gen, device)


class WhisperLM(cm.FrontendLM):
    def __init__(self, cfg: ArchConfig, *, device, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.acfg = cm.AttnCfg(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            qkv_bias=True, use_rope=False)
        self.enc_acfg = cm.AttnCfg(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            qkv_bias=True, use_rope=False, causal=False)
        self.n_enc = cfg.n_encoder_layers or cfg.n_layers
        gen = torch.Generator(device=device).manual_seed(seed)
        d = cfg.d_model
        self.emb = cm.Leaf(torch.randn(cfg.vocab, d, generator=gen,
                                       device=device) * 0.02)
        self.enc_blocks = _EncBlocks(self.n_enc, cfg, self.enc_acfg, gen,
                                     device)
        self.enc_lnf = _LayerNorm((d,), device)
        self.dec_blocks = _DecBlocks(cfg, self.acfg, gen, device)
        self.dec_lnf = _LayerNorm((d,), device)
        self.head = cm.Dense((d, cfg.vocab), False, gen, device)
        self._enc_leaves = cm.leaf_names(self.enc_blocks)
        self._dec_leaves = cm.leaf_names(self.dec_blocks)

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, d) plus the (T, d) sinusoid table in x's dtype."""
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        return x + sinusoid(pos, self.cfg.d_model)[None].to(x.dtype)

    def _lnf(self, tape: Tape, name: str, x: torch.Tensor) -> torch.Tensor:
        ln = getattr(self, name)
        return cm.layernorm(tape, name, x, {"g.w": ln.g.w, "b.w": ln.b.w},
                            path=name)

    def encode(self, frontend: torch.Tensor, tape: Tape) -> torch.Tensor:
        """(B, frames, d) frame embeddings -> (B, frames, d) encoder
        output (after ``enc_lnf``)."""
        x = self._positions(frontend.to(self.cfg.act_dtype))

        def body(sub, p, x):
            h = cm.layernorm(sub, "ln1", x, cm.sub_params(p, "ln1"),
                             path="enc_blocks.ln1")
            x = x + cm.self_attention(sub, "attn", "enc_blocks.attn",
                                      cm.sub_params(p, "attn"), h,
                                      self.enc_acfg)
            h = cm.layernorm(sub, "ln2", x, cm.sub_params(p, "ln2"),
                             path="enc_blocks.ln2")
            return x + cm.gelu_mlp(sub, "mlp", "enc_blocks.mlp",
                                   cm.sub_params(p, "mlp"), h)

        x = scan_blocks(tape, "enc_blocks", body,
                        cm.stacked_leaves(self.enc_blocks, self._enc_leaves),
                        x, self.n_enc)
        return self._lnf(tape, "enc_lnf", x)

    def backbone(self, tokens: torch.Tensor, frontend: torch.Tensor,
                 tape: Tape) -> torch.Tensor:
        """(B, T) decoder tokens and the frames -> (B, T, d) decoder
        hidden states (after ``dec_lnf``)."""
        enc = self.encode(frontend, tape)
        x = L.embed(tape, "emb", tokens, self.emb.w, param_path="emb.w")
        x = self._positions(x.to(self.cfg.act_dtype))

        def body(sub, p, x):
            h = cm.layernorm(sub, "ln1", x, cm.sub_params(p, "ln1"),
                             path="dec_blocks.ln1")
            x = x + cm.self_attention(sub, "attn", "dec_blocks.attn",
                                      cm.sub_params(p, "attn"), h, self.acfg)
            h = cm.layernorm(sub, "lnx", x, cm.sub_params(p, "lnx"),
                             path="dec_blocks.lnx")
            x = x + cm.cross_attention(sub, "xattn", "dec_blocks.xattn",
                                       cm.sub_params(p, "xattn"), h, enc,
                                       self.acfg)
            h = cm.layernorm(sub, "ln2", x, cm.sub_params(p, "ln2"),
                             path="dec_blocks.ln2")
            return x + cm.gelu_mlp(sub, "mlp", "dec_blocks.mlp",
                                   cm.sub_params(p, "mlp"), h)

        x = scan_blocks(tape, "dec_blocks", body,
                        cm.stacked_leaves(self.dec_blocks, self._dec_leaves),
                        x, self.cfg.n_layers)
        return self._lnf(tape, "dec_lnf", x)

