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
* ``decode_attention``: the reference's decode branch of ``attention`` —
  the chunk's T tokens projected, qk-normed and rotated at ``pos + i``,
  their K/V written into the cache (a ring at ``pos mod window`` for a
  sliding window) by ``scatter_rows``, then read through the same ``_sdpa``
  under the reference's mask.  ``init_attn_cache``, ``decode_positions``,
  ``chunk_valid`` and ``gather_last`` are the reference's cache helpers;
  :class:`DecodeSteps` holds the ``decode_step`` and ``prefill_step`` that
  the families with a decode cache share.
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
# queue 1, item 3) and raises there rather than approximate
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


def with_cache(params: dict, prefix: str, cache: dict) -> dict:
    """The leaves of ``params`` under ``prefix.`` with a decode cache's
    leaves added under ``cache.``: what a decode step's ``scan_blocks``
    unbinds layer by layer (the cache's leading axes are the leaves')."""
    stacked = sub_params(params, prefix)
    stacked.update({f"cache.{n}": c for n, c in cache.items()})
    return stacked


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
    window: int = 0          # 0 = full; >0 = sliding window (and ring cache)


# ---------------------------------------------------------------------------
# the KV cache and chunked prefill (decode_attention, DenseLM.decode_step)
# ---------------------------------------------------------------------------

def decode_positions(pos, B: int, device=None) -> torch.Tensor:
    """A decode position argument as a (B,) int32 vector on ``device``: a
    scalar decodes the whole batch in lockstep, a (B,) vector gives every
    cache slot its own write position (continuous batching)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.dim() == 0:
        return pos.expand(B)
    if pos.shape != (B,):
        raise ValueError(f"decode pos must be scalar or shape ({B},); "
                         f"got {tuple(pos.shape)}")
    return pos


def chunk_valid(tokens: torch.Tensor, n_tok: torch.Tensor) -> torch.Tensor:
    """(B, C) bool: token j of a row is consumed iff j < n_tok[row] (0..C).
    Unconsumed tail tokens leave the cache untouched."""
    C = tokens.shape[1]
    return (torch.arange(C, device=tokens.device)[None, :]
            < n_tok.to(tokens.device)[:, None])


def gather_last(x: torch.Tensor, n_tok: torch.Tensor) -> torch.Tensor:
    """x (B, C, ...) -> (B, 1, ...): each row's entry at its last consumed
    index n_tok - 1 (clipped to 0 for a row that consumed nothing, whose
    output the caller ignores)."""
    last = (n_tok.to(x.device).long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), last][:, None]


def scatter_rows(buf: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Write vals (B, T, ...) into buf (B, S, ...) at per-token rows slot
    (B, T), IN PLACE, and return buf.  A row's slots are consecutive
    positions pos + i >= 0 (or their ring rows, each < S).  Writes past S
    and those of tokens that ``valid`` (B, T) masks out are dropped: they
    write back the row's old values.  A token past index S lies past S, so
    the chunk is cut to S tokens, and the rows slot % S of a row are then
    unique: one ``index_put_`` of fixed shape, deterministic without
    ``accumulate``, with no host sync and no second cache-sized buffer."""
    S = buf.shape[1]
    slot, vals = slot[:, :S], vals[:, :S]
    keep = slot < S
    if valid is not None:
        keep = keep & valid[:, :S]
    at = (torch.arange(slot.shape[0], device=buf.device)[:, None],
          (slot % S).long())
    keep = keep.reshape(keep.shape + (1,) * (vals.dim() - 2))
    buf[at] = torch.where(keep, vals.to(buf.dtype), buf[at])
    return buf


class DecodeSteps:
    """``decode_step`` and ``prefill_step`` of a token LM with a decode
    cache.  The family implements ``_decode_layers(params, cache, x, pos,
    valid)``: its layers on the embedded (B, T, d) tokens, each writing its
    slice of the cache IN PLACE; ``valid`` (B, T) masks a chunk's
    unconsumed tail (None: every token).  A model without this mixin has
    no decode path: the serving engine refuses it."""

    @torch.no_grad()
    def _decode_core(self, params, cache, tokens, pos, valid):
        x = L.embed(Tape(), "emb", tokens, params["emb.w"],
                    param_path="emb.w").to(self.cfg.act_dtype)
        x = self._decode_layers(params, cache, x, pos, valid)
        return rmsnorm(Tape(), "lnf", x, {"w": params["lnf.w"]},
                       path="lnf"), cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos):
        """One-token decode: tokens (B, 1) -> (logits (B, V), cache), the
        cache written in place.  ``pos`` is a scalar (lockstep batch) or a
        (B,) vector of per-slot positions (continuous batching)."""
        x, cache = self._decode_core(params, cache, tokens, pos, None)
        logits = L.dense(Tape(), "head", x, params["head.w"],
                         param_path="head")
        return logits[:, 0], cache

    @torch.no_grad()
    def prefill_step(self, params, cache, tokens, pos, n_tok):
        """Chunked prefill: consume tokens (B, C) at per-slot offsets
        ``pos``, row i taking its first n_tok[i] tokens (0..C; the tokens
        past n_tok leave the cache untouched).  Returns (the logits at each
        row's last consumed token (B, V), cache), the cache written in
        place."""
        n_tok = torch.as_tensor(n_tok, device=tokens.device)
        x, cache = self._decode_core(params, cache, tokens, pos,
                                     chunk_valid(tokens, n_tok))
        logits = L.dense(Tape(), "head", gather_last(x, n_tok),
                         params["head.w"], param_path="head")
        return logits[:, 0], cache


def init_attn_cache(B: int, S: int, a: AttnCfg, dtype=torch.bfloat16,
                    device=None) -> Dict[str, torch.Tensor]:
    """Zero K and V of shape (B, S, Hkv, Dh), or (B, window, Hkv, Dh) for a
    sliding window (a ring over positions mod window)."""
    size = a.window if a.window else S
    shape = (B, size, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q (B,T,Hkv,G,Dh), k/v (B,S,Hkv,Dh), mask (B,T,S) or (T,S) bool.

    ``q`` is scaled in its own dtype, both products take their operands in
    f32 (the reference's f32 ``preferred_element_type`` on bf16 inputs: a
    bf16 product is exact in f32), and the probabilities are rounded to
    ``v``'s dtype before the second product.  The scale is filled on the
    device (``torch.tensor`` would copy it from the host, a sync a layer)."""
    scale = torch.full((), q.shape[-1] ** -0.5, dtype=q.dtype,
                       device=q.device)
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


def _attn_inputs(tape: Tape, scope: str, path: str, p: dict,
                 x: torch.Tensor, a: AttnCfg,
                 positions: Optional[torch.Tensor]):
    """The layer's q, k, v projections of ``x`` (B, T, d) in heads, with
    qk-norm where ``a`` has it and RoPE at ``positions`` (B, T) (None: no
    RoPE): the prelude that training and decode share."""
    q, k, v = (_project(tape, scope, path, p, nm, x, a.head_dim)
               for nm in ("wq", "wk", "wv"))
    q, k = _qk_normalize(tape, scope, path, p, q, k, a)
    if a.use_rope and positions is not None:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


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
            f"not ported yet (ROADMAP queue 1, item 3)")

    q, k, v = _attn_inputs(tape, scope, path, p, x, a, positions)
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


def decode_attention(tape: Tape, scope: str, path: str, p: dict,
                     x: torch.Tensor, a: AttnCfg,
                     cache: Dict[str, torch.Tensor], pos,
                     valid: Optional[torch.Tensor] = None):
    """Self attention of a decode or chunked-prefill step against the KV
    cache, the reference's ``attention(..., cache=, pos=, valid=)``.

    ``x`` (B, T, d): T == 1 decodes, T == C consumes a prefill chunk.
    ``cache`` {'k', 'v'} (B, S, Hkv, Dh).  ``pos`` is a scalar or a (B,)
    vector of per-slot start positions; token i of a row lands at pos + i
    (at (pos + i) mod S in a sliding window's ring).  ``valid`` (B, T)
    masks unconsumed chunk-tail tokens: their K/V writes are dropped and
    their outputs are garbage the caller ignores.  Token i reads the cache
    rows at positions <= pos + i (its own chunk's earlier tokens included,
    written by the same scatter), and within the window for a ring.  The
    cache is written IN PLACE (the reference returns a new one); returns
    the (B, T, d) output."""
    B, T, _ = x.shape
    H, Hkv, Dh = a.n_heads, a.n_kv_heads, a.head_dim
    if a.window and T > 1:
        # once a slot's positions wrap the window, a later chunk token's
        # write lands on the ring row an earlier one must still read
        raise ValueError(
            f"chunked prefill (T={T}) is unsupported on sliding-window "
            f"attention (window={a.window}): in-chunk ring writes "
            f"overwrite rows earlier chunk tokens still read once "
            f"positions wrap; serve this arch with prefill_chunk=1")
    posb = decode_positions(pos, B, x.device)
    tok_pos = posb[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=x.device)       # (B, T)
    q, k1, v1 = _attn_inputs(tape, scope, path, p, x, a, tok_pos)
    S = cache["k"].shape[1]
    slot = tok_pos % S if a.window else tok_pos
    scatter_rows(cache["k"], slot, k1, valid)
    scatter_rows(cache["v"], slot, v1, valid)
    sl = torch.arange(S, device=x.device)[None, None, :]           # (1,1,S)
    pc = tok_pos[:, :, None]                                        # (B,T,1)
    if a.window:
        orig = pc - torch.remainder(pc - sl, S)   # the ring row's position
        mask = (orig >= 0) & (orig <= pc) & (orig > pc - a.window)
    else:
        mask = sl <= pc
    o = _sdpa(q.reshape(B, T, Hkv, H // Hkv, Dh), cache["k"], cache["v"],
              mask)
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
