"""ViT classifier — the paper's own benchmark model (ViT-Base/16 @ 224,
CIFAR-100 head), as an ``nn.Module``.

Parameter names are the reference's ``param_path`` strings
(``patch.w``, ``blocks.attn.wq.w``, ``lnf.g.w`` ...).  The transformer
blocks keep the reference's stacked layout: every ``blocks.*`` leaf has a
leading ``n_layers`` axis, unbound once per forward and looped in Python
(:func:`~repro_torch.core.tape.scan_blocks`, under tape scope ``blocks``).
Call the model functionally (:meth:`ViT.loss` uses
``torch.func.functional_call``), so ``torch.func.vmap(torch.func.grad(...))``
gives per-example gradients.  Every parameterised op goes through a tape
primitive, as the reference's ``logits`` does: ``patch`` and ``head`` are
``dense``, ``cls`` and ``pos`` are ``bias``, each layernorm is ``scale`` then
``bias``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core import layers as L
from ..core.tape import Tape, scan_blocks
from . import common as cm


class _LayerNorm(nn.Module):
    def __init__(self, shape, device):
        super().__init__()
        self.g = cm.Leaf(torch.ones(shape, device=device))
        self.b = cm.Leaf(torch.zeros(shape, device=device))


class _Attention(nn.Module):
    def __init__(self, lead, d, h, dh, gen, device):
        super().__init__()
        self.wq = cm.Dense(lead + (d, h * dh), True, gen, device)
        self.wk = cm.Dense(lead + (d, h * dh), True, gen, device)
        self.wv = cm.Dense(lead + (d, h * dh), True, gen, device)
        self.wo = cm.Dense(lead + (h * dh, d), False, gen, device)


class _GeluMLP(nn.Module):
    def __init__(self, lead, d, d_ff, gen, device):
        super().__init__()
        self.w1 = cm.Dense(lead + (d, d_ff), True, gen, device)
        self.w2 = cm.Dense(lead + (d_ff, d), True, gen, device)


class _Blocks(nn.Module):
    """The n_layers transformer blocks, each leaf stacked on axis 0."""

    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        lead, d = (cfg.n_layers,), cfg.d_model
        self.ln1 = _LayerNorm(lead + (d,), device)
        self.attn = _Attention(lead, d, cfg.n_heads, cfg.hd, gen, device)
        self.ln2 = _LayerNorm(lead + (d,), device)
        self.mlp = _GeluMLP(lead, d, cfg.d_ff, gen, device)


class ViT(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device, seed: int = 0):
        super().__init__()
        if cfg.n_kv_heads != cfg.n_heads:
            raise ValueError("ViT attention has n_kv_heads == n_heads")
        self.cfg = cfg
        self.n_patches = (cfg.image_size // cfg.patch) ** 2
        gen = torch.Generator(device=device).manual_seed(seed)
        d, pd = cfg.d_model, cfg.patch * cfg.patch * 3
        self.patch = cm.Dense((pd, d), True, gen, device)
        self.cls = cm.Leaf(torch.zeros(1, d, device=device))
        self.pos = cm.Leaf(torch.randn(self.n_patches + 1, d, generator=gen,
                                     device=device) * 0.02)
        self.blocks = _Blocks(cfg, gen, device)
        self.lnf = _LayerNorm((d,), device)
        self.head = cm.Dense((d, cfg.n_classes), True, gen, device)
        self._block_leaves = cm.leaf_names(self.blocks)

    def params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters as the port's ``{path: tensor}`` dict in
        flatten order (detached views sharing the module's storage)."""
        return cm.path_params(self)

    def _patchify(self, images: torch.Tensor) -> torch.Tensor:
        B, S, _, C = images.shape
        p = self.cfg.patch
        n = S // p
        x = images.reshape(B, n, p, n, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, n * n, p * p * C)

    def forward(self, images: torch.Tensor,
                tape: Optional[Tape] = None) -> torch.Tensor:
        """NHWC images -> (B, n_classes) logits; ``tape`` defaults to a
        plain one."""
        cfg = self.cfg
        tape = Tape() if tape is None else tape
        dt = cfg.act_dtype
        x = L.dense(tape, "patch", self._patchify(images.to(dt)),
                    self.patch.w, self.patch.b, param_path="patch")
        B = x.shape[0]
        cls = L.bias(tape, "cls", x.new_zeros(B, 1, cfg.d_model), self.cls.w,
                     param_path="cls.w")
        x = torch.cat([cls, x], dim=1)
        x = L.bias(tape, "pos", x, self.pos.w, param_path="pos.w")

        def body(sub, p, x):
            h = cm.layernorm(sub, "ln1", x, cm.sub_params(p, "ln1"),
                             path="blocks.ln1")
            x = x + cm.attention(sub, "attn", "blocks.attn",
                                 cm.sub_params(p, "attn"), h, cfg.n_heads,
                                 cfg.hd)
            h = cm.layernorm(sub, "ln2", x, cm.sub_params(p, "ln2"),
                             path="blocks.ln2")
            return x + cm.gelu_mlp(sub, "mlp", "blocks.mlp",
                                   cm.sub_params(p, "mlp"), h)

        x = scan_blocks(tape, "blocks", body,
                        cm.stacked_leaves(self.blocks, self._block_leaves), x,
                        cfg.n_layers)
        x = cm.layernorm(tape, "lnf", x, {"g.w": self.lnf.g.w,
                                          "b.w": self.lnf.b.w}, path="lnf")
        return L.dense(tape, "head", x[:, 0], self.head.w, self.head.b,
                       param_path="head")

    def loss(self, params: Dict[str, torch.Tensor], batch: dict,
             tape: Optional[Tape] = None) -> torch.Tensor:
        """(B,) per-example cross entropy under ``params``; ``tape``
        defaults to a plain one (the record-mode engines pass theirs)."""
        logits = torch.func.functional_call(self, params, (batch["image"],),
                                            {"tape": tape})
        return cm.per_example_ce_single(logits, batch["label"])

