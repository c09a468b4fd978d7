"""Shared model pieces of the ViT and the token LMs, built on the DP
layer primitives (:mod:`repro_torch.core.layers`) so that every
parameterised op is ghost/BK-clippable, as in the reference package's
``models/common.py``.

Each takes ``(tape, name, ..., path)`` as the reference does and follows it
op for op, so the rounding points match:

* ``layernorm``: mean and variance in f32, ``(x - mu) * rsqrt(var + eps)``,
  cast, then the gain (``scale``) and the bias (``bias``) as two ops.
* ``attention`` (the ViT's): ``q`` is scaled in its own dtype BEFORE
  ``q kᵀ``, the scores and softmax are f32, the probabilities are cast to
  ``v``'s dtype, and the output is cast back — the reference's ``_sdpa``
  written as matmul plus softmax, with one KV head per head and no mask.
* ``gelu_mlp``: JAX's default GELU is the tanh approximation, so
  ``approximate="tanh"``.
* ``rmsnorm``: ``x * rsqrt(mean(x²) + eps)`` in f32, cast, then the gain.
* ``apply_rope``: the angles, ``cos`` and ``sin`` in f32; ``x1 * cos``
  promotes a bf16 ``x`` to f32 (as JAX promotes bf16 x f32), and the result
  is cast back once.
* ``self_attention`` (the LM's): the reference's training branch of
  ``attention`` — GQA through ``_sdpa`` (the scores in f32, masked to
  -1e30, an f32 softmax, the probabilities cast to ``v``'s dtype), the
  causal and sliding-window masks (or none, ``causal=False``), RoPE and
  the optional qk-norm.  The reference takes blocked flash attention from
  ``FLASH_MIN_T`` tokens on (causal only); the port has none yet and
  raises there.
* ``cross_attention``: the reference's ``attention(..., kv_x=)`` — the
  queries from the stream, the keys and values projected from a second
  stream of S rows (the encoder's frames, the projected image tokens),
  every key visible, through the same ``_sdpa``.
* ``swiglu``: ``silu(g)`` in f32, cast, then ``* u`` in the activation
  dtype.
* ``lm_head_ce``: the head and the per-example mean CE (log-softmax in f32),
  optionally chunked over T with the head registered as ``shared/head``, so
  the clipping engines fold the chunk axis as exact parameter re-use.

A layer's parameters ``p`` are the port's path-keyed leaves below the
layer's own path (``{"wq.w": ..., "wq.b": ...}`` for ``blocks.attn``).
:class:`TokenLM` is the surface the token LMs (dense, SSM, hybrid, MoE)
share; :class:`FrontendLM` the frontend families' (Whisper, the VLM),
whose batches carry ``frontend`` embeddings besides the tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import layers as L
from ..core.tape import Tape, scan_blocks
from ..utils.params import path_key

# Sequences at or above this length take blocked flash attention in the
# reference (``models/flashattn.py``); the port has not ported it (ROADMAP
# queue 1, item 2) and raises there rather than approximate
FLASH_MIN_T = 8192


# ---------------------------------------------------------------------------
# parameter modules: the reference's nested-dict nodes as nn.Modules
# ---------------------------------------------------------------------------

class Leaf(nn.Module):
    """One parameter named ``w`` (the reference's ``{"w": ...}`` nodes)."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(value)


class Dense(nn.Module):
    """``w`` (..., din, dout) drawn N(0, 1/din) and an optional zero bias
    ``b``; leading axes stack layers."""

    def __init__(self, shape: Tuple[int, ...], bias: bool,
                 gen: torch.Generator, device):
        super().__init__()
        din = shape[-2]
        self.w = nn.Parameter(torch.randn(shape, generator=gen, device=device)
                              * din ** -0.5)
        if bias:
            self.b = nn.Parameter(torch.zeros(shape[:-2] + shape[-1:],
                                              device=device))


def get_path(module: nn.Module, path: str) -> torch.Tensor:
    """The tensor at a dotted ``path`` below ``module`` (under
    ``functional_call``, the one swapped in)."""
    for k in path.split("."):
        module = getattr(module, k)
    return module


def leaf_names(module: nn.Module) -> Tuple[str, ...]:
    """The names of a module's leaves, taken at construction:
    ``named_parameters`` does not list the tensors ``functional_call``
    swaps in."""
    return tuple(n for n, _ in module.named_parameters())


def stacked_leaves(module: nn.Module, names) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a stacked module's leaves (under
    ``functional_call``, the ones swapped in)."""
    return {n: get_path(module, n) for n in names}


def path_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A model's parameters as the port's ``{path: tensor}`` dict in flatten
    order (detached views sharing the module's storage)."""
    named = dict(module.named_parameters())
    return {n: named[n].detach() for n in sorted(named, key=path_key)}


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


# ---------------------------------------------------------------------------
# the dense decoder LM's pieces
# ---------------------------------------------------------------------------

def rmsnorm(tape: Tape, name: str, x: torch.Tensor, p: dict, *, path: str,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xhat = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return L.scale(tape, name, xhat.to(x.dtype), p["w"],
                   param_path=f"{path}.w")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., T, H, Dh), positions (..., T) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # (Dh/2,)
    ang = positions[..., None].float() * freqs            # (..., T, Dh/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., T, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    window: int = 0          # 0 = full; >0 = sliding window


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q (B,T,Hkv,G,Dh), k/v (B,S,Hkv,Dh), mask (B,T,S) or (T,S) bool.

    ``q`` is scaled in its own dtype, both products take their operands in
    f32 (the reference's f32 ``preferred_element_type`` on bf16 inputs: a
    bf16 product is exact in f32), and the probabilities are rounded to
    ``v``'s dtype before the second product."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype, device=q.device)
    s = torch.einsum("btkgd,bskd->bktgs", (q * scale).float(), k.float())
    m = (mask[None, None, :, None, :] if mask.dim() == 2
         else mask[:, None, :, None, :])
    s = torch.where(m, s, -1e30)
    probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bktgs,bskd->btkgd", probs.to(v.dtype).float(),
                     v.float())
    return o.to(v.dtype)


def _qk_normalize(tape: Tape, scope: str, path: str, p: dict, q, k,
                  a: AttnCfg):
    if not a.qk_norm:
        return q, k

    def rn(nm, x):
        xf = x.float()
        xhat = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
        return L.scale(tape, f"{scope}.{nm}", xhat.to(x.dtype), p[f"{nm}.w"],
                       param_path=f"{path}.{nm}.w")
    return rn("qn", q), rn("kn", k)


def self_attention(tape: Tape, scope: str, path: str, p: dict,
                   x: torch.Tensor, a: AttnCfg, *,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence self attention (training): ``p`` holds the layer's
    ``w{q,k,v}.w`` (and ``.b`` with ``a.qkv_bias``), ``wo.w`` and, with
    ``a.qk_norm``, ``{q,k}n.w``; ``positions`` (B, T) gives RoPE's angles
    (None: no RoPE)."""
    B, T, _ = x.shape
    H, Hkv, Dh = a.n_heads, a.n_kv_heads, a.head_dim
    if a.causal and T >= FLASH_MIN_T:
        raise NotImplementedError(
            f"causal attention over T={T} >= FLASH_MIN_T={FLASH_MIN_T} takes "
            f"blocked flash attention in the reference, which the port has "
            f"not ported yet (ROADMAP queue 1, item 2)")

    q, k, v = (_project(tape, scope, path, p, nm, x, Dh)
               for nm in ("wq", "wk", "wv"))
    q, k = _qk_normalize(tape, scope, path, p, q, k, a)
    if a.use_rope and positions is not None:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    ti = torch.arange(T, device=x.device)[:, None]
    si = torch.arange(T, device=x.device)[None, :]
    if a.causal:
        mask = si <= ti
        if a.window:
            mask = mask & (si > ti - a.window)
    else:
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device)
    o = _sdpa(q.reshape(B, T, Hkv, H // Hkv, Dh), k, v, mask)
    return L.dense(tape, f"{scope}.wo", o.reshape(B, T, H * Dh), p["wo.w"],
                   param_path=f"{path}.wo")


def _project(tape: Tape, scope: str, path: str, p: dict, nm: str,
             src: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The ``nm`` projection (and its bias, where ``p`` has one) of
    ``src`` (B, S, d), split into heads: (B, S, heads, head_dim)."""
    return L.dense(tape, f"{scope}.{nm}", src, p[f"{nm}.w"],
                   p.get(f"{nm}.b"), param_path=f"{path}.{nm}").reshape(
        src.shape[0], src.shape[1], -1, head_dim)


def cross_attention(tape: Tape, scope: str, path: str, p: dict,
                    x: torch.Tensor, kv_x: torch.Tensor,
                    a: AttnCfg) -> torch.Tensor:
    """Cross attention (training): the queries from ``x`` (B, T, d), the
    keys and values projected from the second stream ``kv_x`` (B, S, d)
    with ``S`` free of T, every key visible (an all-ones (T, S) mask; no
    qk-norm, no RoPE), as the reference's ``attention(..., kv_x=)``.  ``p``
    holds ``w{q,k,v}.w`` (and ``.b`` with ``a.qkv_bias``) and ``wo.w``."""
    B, T, _ = x.shape
    H, Hkv, Dh = a.n_heads, a.n_kv_heads, a.head_dim
    q = _project(tape, scope, path, p, "wq", x, Dh)
    k = _project(tape, scope, path, p, "wk", kv_x, Dh)
    v = _project(tape, scope, path, p, "wv", kv_x, Dh)
    mask = torch.ones(T, kv_x.shape[1], dtype=torch.bool, device=x.device)
    o = _sdpa(q.reshape(B, T, Hkv, H // Hkv, Dh), k, v, mask)
    return L.dense(tape, f"{scope}.wo", o.reshape(B, T, H * Dh), p["wo.w"],
                   param_path=f"{path}.wo")


def swiglu(tape: Tape, scope: str, path: str, p: dict,
           x: torch.Tensor) -> torch.Tensor:
    g = L.dense(tape, f"{scope}.w1", x, p["w1.w"], param_path=f"{path}.w1")
    u = L.dense(tape, f"{scope}.w3", x, p["w3.w"], param_path=f"{path}.w3")
    h = F.silu(g.float()).to(x.dtype) * u
    return L.dense(tape, f"{scope}.w2", h, p["w2.w"], param_path=f"{path}.w2")


def lm_head_ce(tape: Tape, head_w: torch.Tensor, x: torch.Tensor,
               labels: torch.Tensor, cfg, *, path: str = "head"
               ) -> torch.Tensor:
    """The head dense and the (B,) per-example mean CE, chunked over T when
    ``cfg.ce_chunk`` divides T into several chunks: the full (B, T, V)
    logits never exist, and the head runs once per chunk under
    ``shared/head`` in a ``cechunks`` layer stack, so the engines fold the
    chunk axis as 'uses'."""
    B, T, D = x.shape
    ck = cfg.ce_chunk
    if not ck or T % ck or T <= ck:
        logits = L.dense(tape, "head", x, head_w, param_path=path)
        return per_example_ce(logits, labels)
    nc = T // ck
    chunks = {"x": x.reshape(B, nc, ck, D).transpose(0, 1),      # (nc,B,ck,D)
              "labels": labels.reshape(B, nc, ck).transpose(0, 1)}

    def body(sub, c, acc):
        logits = L.dense(sub, "shared/head", c["x"], head_w, param_path=path)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, c["labels"].long()[..., None])[..., 0]
        return acc - ll.sum(dim=-1)

    acc = scan_blocks(tape, "cechunks", body, chunks,
                      x.new_zeros(B, dtype=torch.float32), nc)
    return acc / T


def per_example_ce(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """logits (B, T, V), labels (B, T) -> (B,) mean CE per example."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -ll.mean(dim=-1)


# ---------------------------------------------------------------------------
# the token LMs' shared surface
# ---------------------------------------------------------------------------

class TokenLM(nn.Module):
    """``emb``, a family's layers, ``lnf`` and ``head``: the parameters as
    ``{path: tensor}``, the logits and the per-example loss.  A family
    builds its layers in ``_build(gen, device)``, drawn between ``emb`` and
    ``head``, and runs them in ``_layers(tape, tokens, x)`` on the
    embedded (B, T, d) activations.  A family with ``has_aux`` (the MoE
    LMs) returns ``(x, aux)`` from ``_layers``, a (B,) f32 auxiliary loss
    that :meth:`forward` adds to the CE (the reference's ``lm_head_ce(...)
    + aux``); the others return ``x`` and their loss is the CE alone.  Call
    the model functionally (:meth:`loss` uses
    ``torch.func.functional_call``)."""

    has_aux = False

    def __init__(self, cfg, *, device, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        d = cfg.d_model
        self.emb = Leaf(torch.randn(cfg.vocab, d, generator=gen,
                                    device=device) * 0.02)
        self._build(gen, device)
        self.lnf = Leaf(torch.ones(d, device=device))
        self.head = Dense((d, cfg.vocab), False, gen, device)

    def _build(self, gen: torch.Generator, device) -> None:
        raise NotImplementedError

    def _layers(self, tape: Tape, tokens: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters as the port's ``{path: tensor}`` dict in
        flatten order (detached views sharing the module's storage)."""
        return path_params(self)

    def backbone_aux(self, tokens: torch.Tensor, tape: Tape):
        """(B, T) token ids -> ((B, T, d) final-normed hidden states, the
        (B,) auxiliary loss or None)."""
        x = L.embed(tape, "emb", tokens, self.emb.w, param_path="emb.w")
        x = self._layers(tape, tokens, x.to(self.cfg.act_dtype))
        x, aux = x if self.has_aux else (x, None)
        return rmsnorm(tape, "lnf", x, {"w": self.lnf.w}, path="lnf"), aux

    def backbone(self, tokens: torch.Tensor, tape: Tape) -> torch.Tensor:
        """(B, T) token ids -> (B, T, d) final-normed hidden states."""
        return self.backbone_aux(tokens, tape)[0]

    def logits(self, tokens: torch.Tensor,
               tape: Optional[Tape] = None) -> torch.Tensor:
        """(B, T) token ids -> (B, T, vocab) logits."""
        tape = Tape() if tape is None else tape
        return L.dense(tape, "head", self.backbone(tokens, tape), self.head.w,
                       param_path="head")

    def forward(self, tokens: torch.Tensor, labels: torch.Tensor,
                tape: Optional[Tape] = None) -> torch.Tensor:
        """(B,) per-example mean next-token CE (the head chunked over T
        with ``cfg.ce_chunk``), plus the auxiliary loss of a family that
        has one; ``tape`` defaults to a plain one."""
        tape = Tape() if tape is None else tape
        x, aux = self.backbone_aux(tokens, tape)
        ce = lm_head_ce(tape, self.head.w, x, labels, self.cfg)
        return ce if aux is None else ce + aux

    def loss(self, params: Dict[str, torch.Tensor], batch: dict,
             tape: Optional[Tape] = None) -> torch.Tensor:
        """(B,) per-example losses under ``params``; ``tape`` defaults to a
        plain one (the record-mode engines pass theirs)."""
        return torch.func.functional_call(
            self, params, (batch["tokens"], batch["labels"]), {"tape": tape})


# ---------------------------------------------------------------------------
# the frontend families' shared surface
# ---------------------------------------------------------------------------

class FrontendLM(nn.Module):
    """The surface Whisper and the VLM share: the parameters as ``{path:
    tensor}``, the logits and the per-example loss of a batch whose
    ``frontend`` (B, frames, dim) f32 embeddings (the stubbed audio or
    vision encoder's output) come with its ``tokens`` and ``labels``.  A
    family builds its leaves (``head`` among them) in ``__init__`` and runs
    ``backbone(tokens, frontend, tape)`` to the final-normed (B, T, d)
    hidden states.  Call the model functionally (:meth:`loss` uses
    ``torch.func.functional_call``): under ``vmap(grad)`` the frontend is
    mapped with the tokens, one example's frames at a time."""

    def params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters as the port's ``{path: tensor}`` dict in
        flatten order (detached views sharing the module's storage)."""
        return path_params(self)

    def backbone(self, tokens: torch.Tensor, frontend: torch.Tensor,
                 tape: Tape) -> torch.Tensor:
        raise NotImplementedError

    def logits(self, tokens: torch.Tensor, frontend: torch.Tensor,
               tape: Optional[Tape] = None) -> torch.Tensor:
        """(B, T) token ids and the frontend -> (B, T, vocab) logits."""
        tape = Tape() if tape is None else tape
        return L.dense(tape, "head", self.backbone(tokens, frontend, tape),
                       self.head.w, param_path="head")

    def forward(self, tokens: torch.Tensor, frontend: torch.Tensor,
                labels: torch.Tensor,
                tape: Optional[Tape] = None) -> torch.Tensor:
        """(B,) per-example mean next-token CE (the head chunked over T
        with ``cfg.ce_chunk``); ``tape`` defaults to a plain one."""
        tape = Tape() if tape is None else tape
        x = self.backbone(tokens, frontend, tape)
        return lm_head_ce(tape, self.head.w, x, labels, self.cfg)

    def loss(self, params: Dict[str, torch.Tensor], batch: dict,
             tape: Optional[Tape] = None) -> torch.Tensor:
        """(B,) per-example losses under ``params``; ``tape`` defaults to a
        plain one (the record-mode engines pass theirs)."""
        return torch.func.functional_call(
            self, params, (batch["tokens"], batch["frontend"],
                           batch["labels"]), {"tape": tape})
