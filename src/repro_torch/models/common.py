"""Shared model pieces the ViT uses, built on the DP layer primitives
(:mod:`repro_torch.core.layers`) so that every parameterised op is
ghost/BK-clippable, as in the reference package's ``models/common.py``.

Each takes ``(tape, name, ..., path)`` as the reference does and follows it
op for op, so the rounding points match:

* ``layernorm``: mean and variance in f32, ``(x - mu) * rsqrt(var + eps)``,
  cast, then the gain (``scale``) and the bias (``bias``) as two ops.
* ``attention``: ``q`` is scaled in its own dtype BEFORE ``q kᵀ``, the
  scores and softmax are f32, the probabilities are cast to ``v``'s dtype,
  and the output is cast back — the reference's ``_sdpa`` written as matmul
  plus softmax.
* ``gelu_mlp``: JAX's default GELU is the tanh approximation, so
  ``approximate="tanh"``.

A layer's parameters ``p`` are the port's path-keyed leaves below the
layer's own path (``{"wq.w": ..., "wq.b": ...}`` for ``blocks.attn``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import layers as L
from ..core.tape import Tape


def sub_params(p: dict, prefix: str) -> dict:
    """The leaves of ``p`` under ``prefix.``, with the prefix dropped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + ".")}


def layernorm(tape: Tape, name: str, x: torch.Tensor, p: dict, *, path: str,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xhat = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    h = L.scale(tape, f"{name}.g", xhat, p["g.w"], param_path=f"{path}.g.w")
    return L.bias(tape, f"{name}.b", h, p["b.w"], param_path=f"{path}.b.w")


def attention(tape: Tape, scope: str, path: str, p: dict, x: torch.Tensor,
              n_heads: int, head_dim: int) -> torch.Tensor:
    """Bidirectional multi-head self attention; ``p`` holds the layer's
    ``w{q,k,v,o}.{w,b}`` leaves (no ``wo`` bias, as in the reference)."""
    B, T, _ = x.shape

    def proj(nm):
        return L.dense(tape, f"{scope}.{nm}", x, p[f"{nm}.w"],
                       p.get(f"{nm}.b"), param_path=f"{path}.{nm}").reshape(
            B, T, n_heads, head_dim)

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    scale = torch.tensor(head_dim ** -0.5, dtype=q.dtype, device=q.device)
    s = torch.einsum("bthd,bshd->bhts", (q * scale).float(), k.float())
    probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(),
                     v.float()).to(v.dtype)
    return L.dense(tape, f"{scope}.wo", o.reshape(B, T, n_heads * head_dim),
                   p["wo.w"], param_path=f"{path}.wo")


def gelu_mlp(tape: Tape, scope: str, path: str, p: dict,
             x: torch.Tensor) -> torch.Tensor:
    h = L.dense(tape, f"{scope}.w1", x, p["w1.w"], p["w1.b"],
                param_path=f"{path}.w1")
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return L.dense(tape, f"{scope}.w2", h, p["w2.w"], p["w2.b"],
                   param_path=f"{path}.w2")


def per_example_ce_single(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits (B, V), labels (B,) -> (B,) cross entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
