"""Shared model pieces the ViT uses, as plain functions on tensors.

Each follows the reference package's ``models/common.py`` and
``core/layers.py`` op for op, so the rounding points match:

* ``dense``: the product runs in f32 (a bf16 ``x`` is upcast, as JAX
  promotes bf16 x f32), the result is cast to ``x``'s dtype, and the bias is
  added after the cast.  TF32 is off on the card (``utils.device``).
* ``layernorm``: mean and variance in f32, ``(x - mu) * rsqrt(var + eps)``,
  cast, then scale and bias as two separate ops.
* ``attention``: ``q`` is scaled in its own dtype BEFORE ``q kᵀ``, the
  scores and softmax are f32, the probabilities are cast to ``v``'s dtype,
  and the output is cast back — the reference's ``_sdpa`` written as matmul
  plus softmax.
* ``gelu``: JAX's default is the tanh approximation, so ``approximate="tanh"``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[..., o] = x[..., i] @ w[i, o] (+ b[o])."""
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xhat = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    h = xhat * g.to(x.dtype)
    return h + b.to(h.dtype)


def attention(x: torch.Tensor, p: dict, n_heads: int,
              head_dim: int) -> torch.Tensor:
    """Bidirectional multi-head self attention; ``p`` holds the layer's
    ``attn.w{q,k,v,o}.{w,b}`` leaves (no ``wo`` bias, as in the reference)."""
    B, T, _ = x.shape

    def proj(nm):
        return dense(x, p[f"attn.{nm}.w"], p.get(f"attn.{nm}.b")).reshape(
            B, T, n_heads, head_dim)

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    scale = torch.tensor(head_dim ** -0.5, dtype=q.dtype, device=q.device)
    s = torch.einsum("bthd,bshd->bhts", (q * scale).float(), k.float())
    probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(),
                     v.float()).to(v.dtype)
    return dense(o.reshape(B, T, n_heads * head_dim), p["attn.wo.w"])


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = dense(x, p["mlp.w1.w"], p["mlp.w1.b"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(h, p["mlp.w2.w"], p["mlp.w2.b"])


def per_example_ce_single(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits (B, V), labels (B,) -> (B,) cross entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
