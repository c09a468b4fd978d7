"""Mixture-of-Experts as an ``nn.Module``: top-k routing with a per-expert
capacity and scatter dispatch — the reference's ``models/moe.py``
(``moe_params``, ``moe_block``, ``MoeLM``), training only (serving's
cache, decode and prefill wait for ROADMAP queue 1, item 7).

Expert weights are stacked on a leading E axis (``blocks.moe.w1.w`` is
(n_layers, E, d, f)) and go through ``dense_stacked``, whose E axis the
clipping engines treat as a layer axis: per-example norms and BK grads are
exact per expert.  The router's load-balance loss is computed per example
and added to the CE before clipping, so the guarantee covers the router's
gradient too.

Routing follows the reference op for op, with three choices made for
PyTorch:

* the top k come from a stable descending sort of the f32 probabilities,
  so equal probabilities put the lower expert first, as
  ``jax.lax.top_k`` does (``torch.topk`` promises no order on ties), and
  the order of the k picks fixes each token's slot and which token the
  capacity drops;
* dispatch scatters into E·cap + 1 rows and drops the last: a dropped
  token's index is E·cap (the reference's ``mode="drop"``), every kept
  slot is written once, so the result is exact and the same on every run
  (duplicates, and the atomics they cost on the card, all land in the
  discarded row);
* the one-hot is a comparison with ``arange(E)`` and every op is out of
  place, so the block runs under ``torch.func.vmap(grad)``.

The capacity comes from T alone (not B), so examples stay independent:
what per-example clipping needs.  ``maybe_shard_expert`` has no
counterpart (one device).
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..core import layers as L
from ..core.tape import Tape, scan_blocks
from . import common as cm
from .transformer import _Attention

# when a list, moe_block appends each call's (expert indices, valid mask)
_ROUTING: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def capture_routing():
    """Collect each ``moe_block`` call's (B, T·K) expert indices and their
    (B, T·K) kept-at-capacity mask, in call order, into the yielded list
    (under ``vmap``, return the list from the mapped function)."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


def routing(loss_fn, params: dict, batch: dict, per_example: bool = False):
    """The routing each ``moe_block`` of a forward selects, as a list of
    (expert indices, kept mask) pairs of shape (B, T·K), in layer order:
    of the batched forward (the record engines and ``nonprivate``), or
    with ``per_example`` of one forward per example under ``vmap`` (the
    per-example engines: ``masked_pe``, ``masked_fused``, the stream)."""
    if not per_example:
        with torch.no_grad(), capture_routing() as got:
            loss_fn(params, batch)
        return list(zip(got[::2], got[1::2]))

    def one(ex):
        with capture_routing() as got:
            loss_fn(params, {k: v.unsqueeze(0) for k, v in ex.items()})
        return [t[0] for t in got]

    with torch.no_grad():
        got = torch.func.vmap(one)(batch)
    return list(zip(got[::2], got[1::2]))


class MoEParams(nn.Module):
    """One MoE FFN's leaves with leading axes ``lead``, drawn as the
    reference's ``moe_params``: the router (d, E) and the experts' w1, w3
    (E, d, f) N(0, 1/d), w2 (E, f, d) N(0, 1/f)."""

    def __init__(self, lead, d: int, n_experts: int, d_ff: int, gen,
                 device):
        super().__init__()
        self.router = cm.Dense(lead + (d, n_experts), False, gen, device)
        self.w1 = cm.Dense(lead + (n_experts, d, d_ff), False, gen, device)
        self.w3 = cm.Dense(lead + (n_experts, d, d_ff), False, gen, device)
        self.w2 = cm.Dense(lead + (n_experts, d_ff, d), False, gen, device)


def capacity(T: int, cfg: ArchConfig) -> int:
    """Slots per expert and example: ceil(T·K·capacity_factor / E)."""
    return math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts)


def moe_block(tape: Tape, scope: str, path: str, p: dict, x: torch.Tensor,
              cfg: ArchConfig):
    """x (B, T, D) -> (out (B, T, D), aux (B,) f32); ``p`` holds the
    block's ``router.w``, ``w1.w``, ``w3.w`` and ``w2.w``."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = capacity(T, cfg)

    logits = L.dense(tape, f"{scope}.router", x, p["router.w"],
                     param_path=f"{path}.router")
    probs = torch.softmax(logits.float(), dim=-1)                  # (B,T,E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = order.values[..., :K], order.indices[..., :K]     # (B,T,K)
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)

    # position in expert over the T·K virtual-token axis (exclusive cumsum)
    e_flat = topi.reshape(B, T * K)
    oh = (e_flat[..., None] == torch.arange(E, device=x.device)).to(
        torch.int32)                                                # (B,TK,E)
    pos = torch.cumsum(oh, dim=1) - oh
    pos = torch.gather(pos, -1, e_flat[..., None])[..., 0]          # (B,TK)
    valid = pos < cap
    idx = torch.where(valid, e_flat * cap + pos,
                      torch.full_like(e_flat, E * cap))
    if _ROUTING is not None:
        _ROUTING.extend((e_flat, valid))

    # dispatch: each kept token into its slot; row E·cap takes the drops
    x_rep = x.repeat_interleave(K, dim=1)                           # (B,TK,D)
    buf = torch.zeros(B, E * cap + 1, D, dtype=x.dtype,
                      device=x.device).scatter_add(
        1, idx[..., None].expand(B, T * K, D), x_rep)[:, :E * cap]
    buf = buf.reshape(B, E, cap, D).transpose(0, 1).contiguous()  # E,B,cap,D

    # the experts: w1 and w3 share the dispatch buffer's one record
    g, u = L.dense_stacked_pair(tape, f"{scope}.w13", buf, p["w1.w"],
                                p["w3.w"], param_path1=f"{path}.w1",
                                param_path2=f"{path}.w3")
    h = F.silu(g.float()).to(x.dtype) * u
    yb = L.dense_stacked(tape, f"{scope}.w2", h, p["w2.w"],
                         param_path=f"{path}.w2")                 # E,B,cap,D

    # combine: gather each token's K outputs back, weighted by the gates
    yb = yb.transpose(0, 1).reshape(B, E * cap, D)
    gathered = torch.gather(
        yb, 1, idx.clamp(max=E * cap - 1)[..., None].expand(B, T * K, D))
    w = topv.reshape(B, T * K) * valid.float()
    y = (gathered.float() * w[..., None]).reshape(B, T, K, D)
    y = y.sum(dim=2).to(x.dtype)

    # per-example load-balance loss (Switch-style)
    f = oh.float().mean(dim=1)                                      # (B,E)
    pmean = probs.mean(dim=1)                                       # (B,E)
    aux = E * (f * pmean).sum(dim=-1) * cfg.router_aux_coef         # (B,)
    return y, aux


class _Blocks(nn.Module):
    """The n_layers decoder blocks, each leaf stacked on axis 0."""

    def __init__(self, cfg: ArchConfig, a: cm.AttnCfg, gen, device):
        super().__init__()
        lead, d = (cfg.n_layers,), cfg.d_model
        self.ln1 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.attn = _Attention(lead, d, a, gen, device)
        self.ln2 = cm.Leaf(torch.ones(lead + (d,), device=device))
        self.moe = MoEParams(lead, d, cfg.n_experts,
                             cfg.moe_d_ff or cfg.d_ff, gen, device)


class MoeLM(cm.TokenLM):
    """OLMoE-style decoder LM: every FFN is a top-k MoE, attention as in
    DenseLM (with qk-norm)."""

    has_aux = True

    def _build(self, gen, device):
        cfg = self.cfg
        self.acfg = cm.AttnCfg(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window)
        self.blocks = _Blocks(cfg, self.acfg, gen, device)
        self._block_leaves = cm.leaf_names(self.blocks)

    def _layers(self, tape: Tape, tokens: torch.Tensor, x: torch.Tensor):
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)

        def body(sub, p, carry):
            x, aux = carry
            h = cm.rmsnorm(sub, "ln1", x, cm.sub_params(p, "ln1"),
                           path="blocks.ln1")
            x = x + cm.self_attention(sub, "attn", "blocks.attn",
                                      cm.sub_params(p, "attn"), h, self.acfg,
                                      positions=positions)
            h = cm.rmsnorm(sub, "ln2", x, cm.sub_params(p, "ln2"),
                           path="blocks.ln2")
            y, aux_l = moe_block(sub, "moe", "blocks.moe",
                                 cm.sub_params(p, "moe"), h, self.cfg)
            return x + y, aux + aux_l

        return scan_blocks(
            tape, "blocks", body,
            cm.stacked_leaves(self.blocks, self._block_leaves),
            (x, x.new_zeros(tokens.shape[0], dtype=torch.float32)),
            self.cfg.n_layers)
