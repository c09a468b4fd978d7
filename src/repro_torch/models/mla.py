"""Multi-head Latent Attention (DeepSeek-V2) and the DeepseekV2 MoE LM as
``nn.Module``\\ s — the reference's ``models/mla.py`` (``mla_params``,
``mla_attention``, ``DeepseekV2LM``), training only (``mla_decode`` and
serving wait for ROADMAP queue 1, item 7).

MLA compresses K and V into a rank-``kv_lora`` latent ``c`` (``wdkv``,
then an RMSNorm with the gain ``ckv_norm``, then ``wukv``) beside one
small RoPE key shared by every head (``wkr``).  The training form follows
the reference op for op: both score products, the softmax and the
probabilities-times-V product run in f32 (the probabilities are not
rounded to V's dtype, unlike ``_sdpa``), and the output is cast back once.

The model's leaves: ``dense_blocks.*`` (the ``first_dense_layers``
leading layers: MLA and a SwiGLU of width ``dense_d_ff``), ``moe_blocks.*``
(MLA, the routed experts of :func:`~.moe.moe_block`, and ``shared``, a
SwiGLU of width ``n_shared_experts * moe_d_ff`` every token takes), then
:class:`~.common.TokenLM`'s ``emb``, ``lnf`` and ``head``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core import layers as L
from ..core.tape import Tape, scan_blocks
from . import common as cm
from .moe import MoEParams, moe_block
from .transformer import _SwiGLU

QK_NOPE = 128
V_HEAD = 128


def _dims(cfg: ArchConfig):
    """(non-RoPE query/key width, value width, RoPE width) per head."""
    return min(QK_NOPE, cfg.hd), min(V_HEAD, cfg.hd), cfg.rope_dim


class MLAParams(nn.Module):
    """One MLA layer's leaves with leading axes ``lead``, drawn N(0, 1/din)
    as the reference's ``mla_params``; the latent's norm gain is ones."""

    def __init__(self, lead, cfg: ArchConfig, gen, device):
        super().__init__()
        D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora
        nope, vh, rd = _dims(cfg)
        self.wq = cm.Dense(lead + (D, H * (nope + rd)), False, gen, device)
        self.wdkv = cm.Dense(lead + (D, r), False, gen, device)
        self.ckv_norm = cm.Leaf(torch.ones(lead + (r,), device=device))
        self.wukv = cm.Dense(lead + (r, H * (nope + vh)), False, gen, device)
        self.wkr = cm.Dense(lead + (D, rd), False, gen, device)
        self.wo = cm.Dense(lead + (H * vh, D), False, gen, device)


def mla_attention(tape: Tape, scope: str, path: str, p: dict,
                  x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Causal MLA over the full sequence: x (B, T, D), positions (B, T)."""
    B, T, _ = x.shape
    H = cfg.n_heads
    nope, vh, rd = _dims(cfg)

    q = L.dense(tape, f"{scope}.wq", x, p["wq.w"], param_path=f"{path}.wq")
    q = q.reshape(B, T, H, nope + rd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    c = L.dense(tape, f"{scope}.wdkv", x, p["wdkv.w"],
                param_path=f"{path}.wdkv")
    c = cm.rmsnorm(tape, f"{scope}.ckv_norm", c,
                   cm.sub_params(p, "ckv_norm"), path=f"{path}.ckv_norm")
    kv = L.dense(tape, f"{scope}.wukv", c, p["wukv.w"],
                 param_path=f"{path}.wukv").reshape(B, T, H, nope + vh)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k_rope = L.dense(tape, f"{scope}.wkr", x, p["wkr.w"],
                     param_path=f"{path}.wkr").reshape(B, T, 1, rd)

    q_rope = cm.apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = cm.apply_rope(k_rope, positions, cfg.rope_theta)

    scl = (nope + rd) ** -0.5
    s = (torch.einsum("bthd,bshd->bhts", q_nope.float(), k_nope.float())
         + torch.einsum("bthd,bsd->bhts", q_rope.float(),
                        k_rope[:, :, 0].float())) * scl
    ti = torch.arange(T, device=x.device)
    mask = ti[None, :] <= ti[:, None]
    s = torch.where(mask[None, None], s, -1e30)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", a, v.float()).to(x.dtype)
    return L.dense(tape, f"{scope}.wo", o.reshape(B, T, H * vh), p["wo.w"],
                   param_path=f"{path}.wo")


class _DenseBlocks(nn.Module):
    def __init__(self, n: int, cfg: ArchConfig, gen, device):
        super().__init__()
        lead, d = (n,), cfg.d_model
        self.ln1 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.attn = MLAParams(lead, cfg, gen, device)
        self.ln2 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.mlp = _SwiGLU(lead, d, cfg.dense_d_ff or 4 * d, gen, device)


class _MoEBlocks(nn.Module):
    def __init__(self, n: int, cfg: ArchConfig, gen, device):
        super().__init__()
        lead, d = (n,), cfg.d_model
        d_ff = cfg.moe_d_ff or cfg.d_ff
        self.ln1 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.attn = MLAParams(lead, cfg, gen, device)
        self.ln2 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.moe = MoEParams(lead, d, cfg.n_experts, d_ff, gen, device)
        self.shared = _SwiGLU(lead, d, cfg.n_shared_experts * d_ff, gen,
                              device)


class DeepseekV2LM(cm.TokenLM):
    """MLA attention; ``first_dense_layers`` leading layers with a dense
    SwiGLU, the rest with the routed experts plus the shared ones."""

    has_aux = True

    def _build(self, gen, device):
        cfg = self.cfg
        self.n_dense = cfg.first_dense_layers
        self.n_moe = cfg.n_layers - self.n_dense
        self.dense_blocks = _DenseBlocks(self.n_dense, cfg, gen, device)
        self.moe_blocks = _MoEBlocks(self.n_moe, cfg, gen, device)
        self._dense_leaves = cm.leaf_names(self.dense_blocks)
        self._moe_leaves = cm.leaf_names(self.moe_blocks)

    def _layers(self, tape: Tape, tokens: torch.Tensor, x: torch.Tensor):
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)

        def attend(sub, p, x, path):
            h = cm.rmsnorm(sub, "ln1", x, cm.sub_params(p, "ln1"),
                           path=f"{path}.ln1")
            x = x + mla_attention(sub, "attn", f"{path}.attn",
                                  cm.sub_params(p, "attn"), h, cfg, positions)
            return x, cm.rmsnorm(sub, "ln2", x, cm.sub_params(p, "ln2"),
                                 path=f"{path}.ln2")

        def dense_body(sub, p, x):
            x, h = attend(sub, p, x, "dense_blocks")
            return x + cm.swiglu(sub, "mlp", "dense_blocks.mlp",
                                 cm.sub_params(p, "mlp"), h)

        def moe_body(sub, p, carry):
            x, aux = carry
            x, h = attend(sub, p, x, "moe_blocks")
            y, aux_l = moe_block(sub, "moe", "moe_blocks.moe",
                                 cm.sub_params(p, "moe"), h, cfg)
            y = y + cm.swiglu(sub, "shared", "moe_blocks.shared",
                              cm.sub_params(p, "shared"), h)
            return x + y, aux + aux_l

        x = scan_blocks(tape, "dense_blocks", dense_body,
                        cm.stacked_leaves(self.dense_blocks,
                                          self._dense_leaves), x,
                        self.n_dense)
        return scan_blocks(
            tape, "moe_blocks", moe_body,
            cm.stacked_leaves(self.moe_blocks, self._moe_leaves),
            (x, x.new_zeros(tokens.shape[0], dtype=torch.float32)),
            self.n_moe)
