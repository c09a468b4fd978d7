"""Mamba2 (SSD, state-space duality; Dao & Gu 2024) as an ``nn.Module``:
the reference's ``models/mamba2.py``, training and serving (the decode
cache, ``mamba_decode``, ``decode_step`` and chunked ``prefill_step``).

The SSD scan runs chunkwise, as in the reference: attention-like products
inside each chunk and a linear recurrence over the chunks.  Its parameters
decompose onto the DP primitives: ``in_proj`` and ``out_proj`` are
``dense``, the conv ``conv1d_depthwise``, ``dt_bias`` a ``bias``, and
``a_neg`` (the negative decay rate) and ``D`` are ``scale``; the recurrence
itself has no parameter, so the ghost and book-keeping engines cover every
leaf.

Parameter names are the reference's ``param_path`` strings
(``blocks.mamba.in_proj.w``, ``blocks.mamba.a_neg.w`` ...), with the
stacked ``blocks.*`` layout of :mod:`.transformer`; the embedding, final
norm, head and loss are :class:`~.common.TokenLM`'s.

Serving keeps, per layer and slot, the SSM state (H, N, P) in f32 and the
conv's last K-1 inputs, the reference's cache ``{"blocks": {"state",
"conv"}}``.  Neither is indexed by position: both ACCUMULATE, so the
serving pool resets them when a slot is reused and refuses prefix
sharing.  A decode or chunk step runs the projections, the conv and the
gating batched over the chunk and the recurrence as a loop of
``ssd_step`` over its tokens, as the reference does (its chunked prefill
is then bit-identical to per-token decode; the port's GEMMs round a chunk
of C rows unlike one of 1, so here it is held within a bound).  The
cache is written IN PLACE; a row that consumes nothing in a chunk keeps
its state and conv bit for bit (written back through the mask).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..core import layers as L
from ..core.tape import Tape, scan_blocks
from . import common as cm


# ---------------------------------------------------------------------------
# SSD core (parameter-free)
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, u, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan, in f32.

    x  (B, T, H, P) inputs per head
    dt (B, T, H)    step sizes (post-softplus)
    u  (B, T, H)    log-decay per step = dt * a  (a < 0)
    Bm, Cm (B, T, N) input and output projections (one group)
    Returns (y (B, T, H, P) f32, final state (B, H, N, P) f32).

    The reference's three-operand einsums are written as two pairwise
    products each (an elementwise product, then one batched matmul), so no
    (B, nc, Q, Q, H, P) intermediate exists.  The causal mask is applied
    before ``exp`` (-1e30 above the diagonal: no overflow, no NaN
    gradient), and the inter-chunk recurrence is a loop over the chunks
    that keeps the state BEFORE each chunk, stacked (no in-place write, so
    ``torch.func.vmap`` batches it)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"T={T} not divisible by chunk={Q}")
    nc = T // Q

    xr = x.reshape(Bsz, nc, Q, H, P).float()
    dtr = dt.reshape(Bsz, nc, Q, H).float()
    ur = u.reshape(Bsz, nc, Q, H).float()
    Br = Bm.reshape(Bsz, nc, Q, N).float()
    Cr = Cm.reshape(Bsz, nc, Q, N).float()

    cs = torch.cumsum(ur, dim=2)                          # inclusive
    # intra-chunk: Lmat[q, k] = exp(cs_q - cs_k) for k <= q
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (B,nc,Q,Q,H)
    ar = torch.arange(Q, device=x.device)
    tri = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    Lmat = torch.exp(torch.where(tri, diff, -1e30))
    CB = torch.einsum("bcqn,bckn->bcqk", Cr, Br)          # (B,nc,Q,Q)
    xdt = xr * dtr[..., None]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", CB[..., None] * Lmat, xdt)

    # chunk states: S_c = sum_k exp(cs_last - cs_k) dt_k B_k x_k^T
    dte = torch.exp(cs[:, :, -1:, :] - cs) * dtr          # (B,nc,Q,H)
    S_chunks = torch.einsum("bckn,bckhp->bchnp", Br, dte[..., None] * xr)
    chunk_decay = torch.exp(cs[:, :, -1, :])              # (B,nc,H)

    S = (torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(S)                                    # state BEFORE c
        S = S * chunk_decay[:, c, :, None, None] + S_chunks[:, c]
    S_prev = torch.stack(prev, dim=1)                     # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cr, S_prev) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, T, H, P)
    return y, S


def ssd_step(state, x, dt, u, Bm, Cm):
    """One-token recurrence: state (B, H, N, P); x (B, H, P); dt, u (B, H);
    Bm, Cm (B, N).  Returns (y (B, H, P), new state), in f32."""
    dec = torch.exp(u.float())
    upd = Bm.float()[:, None, :, None] * (dt.float()[:, :, None]
                                          * x.float())[:, :, None, :]
    state = state * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), state)
    return y, state


# ---------------------------------------------------------------------------
# the Mamba2 block (parameters through the DP primitives)
# ---------------------------------------------------------------------------

class MambaParams(nn.Module):
    """One mamba mixer's leaves, each with leading axes ``lead`` (stacked
    layers), drawn as the reference's ``mamba_params`` draws them:
    projections N(0, 1/din), the conv N(0, 1)·0.2, ``a_neg`` =
    −exp(U(log 1, log 16)), ``D`` ones, ``dt_bias`` zeros, the gated norm's
    gain ones."""

    def __init__(self, lead, cfg: ArchConfig, gen, device):
        super().__init__()
        D, di, H, N = cfg.d_model, cfg.d_inner, cfg.nheads_ssm, cfg.ssm_state
        self.in_proj = cm.Dense(lead + (D, 2 * di + 2 * N + H), False, gen,
                                device)
        self.conv = cm.Leaf(torch.randn(lead + (cfg.conv_width, di + 2 * N),
                                        generator=gen, device=device) * 0.2)
        self.dt_bias = cm.Leaf(torch.zeros(lead + (H,), device=device))
        u = torch.rand(lead + (H,), generator=gen, device=device)
        self.a_neg = cm.Leaf(-torch.exp(u * math.log(16.0)))
        self.D = cm.Leaf(torch.ones(lead + (H,), device=device))
        self.ssm_norm = cm.Leaf(torch.ones(lead + (di,), device=device))
        self.out_proj = cm.Dense(lead + (di, D), False, gen, device)


def conv_window_step(xbc, tail, w, valid=None):
    """The causal depthwise conv of a decode or chunk step: xbc (B, T, C)
    after the cached tail (B, K-1, C) of earlier inputs; token t reads rows
    [t, t + K) of the concatenation, in f32 (the reference's
    ``einsum("btkc,kc->btc")``).  Returns (the conv output (B, T, C) in
    f32, the new tail): each row's last K-1 rows of [tail, the tokens it
    consumed] (``valid`` (B, T) masks the rest; None: all T), never past an
    unconsumed chunk-tail token, so a row that consumed nothing keeps its
    tail's bits."""
    T, K = xbc.shape[1], tail.shape[1] + 1
    dtype = torch.promote_types(tail.dtype, xbc.dtype)
    win = torch.cat([tail.to(dtype), xbc.to(dtype)], dim=1)   # (B, K-1+T, C)
    y = torch.einsum("btck,kc->btc", win.unfold(1, K, 1).float(), w.float())
    if valid is None:
        return y, win[:, T:]
    n_tok = valid.sum(dim=1)
    idx = n_tok[:, None] + torch.arange(K - 1, device=xbc.device)
    return y, torch.gather(win, 1, idx[:, :, None].expand(-1, -1,
                                                          win.shape[2]))


def _mamba_pre(tape: Tape, scope: str, path: str, p: dict, x, cfg,
               conv_window=None, valid=None):
    """The projection, conv and gating prologue.  Training (no
    ``conv_window``): the conv is ``conv1d_depthwise`` over the sequence.
    Decode: ``conv_window`` (B, K-1, C) holds the cached tail and
    ``valid`` (B, T) masks a chunk's unconsumed tokens
    (:func:`conv_window_step`).  Returns (z, xs, Bm, Cm, dt, u, the new
    conv tail or None)."""
    di, H, N = cfg.d_inner, cfg.nheads_ssm, cfg.ssm_state
    zxbcdt = L.dense(tape, f"{scope}.in_proj", x, p["in_proj.w"],
                     param_path=f"{path}.in_proj")
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt_raw = zxbcdt[..., -H:]
    if conv_window is None:
        xbc_c = L.conv1d_depthwise(tape, f"{scope}.conv", xbc, p["conv.w"],
                                   param_path=f"{path}.conv.w")
        new_tail = None
    else:
        xbc_c, new_tail = conv_window_step(xbc, conv_window, p["conv.w"],
                                           valid)
        xbc_c = xbc_c.to(x.dtype)
    xbc_c = F.silu(xbc_c.float()).to(x.dtype)
    xs, Bm, Cm = xbc_c[..., :di], xbc_c[..., di:di + N], xbc_c[..., di + N:]
    dt_raw = L.bias(tape, f"{scope}.dt_bias", dt_raw, p["dt_bias.w"],
                    param_path=f"{path}.dt_bias.w")
    dt = F.softplus(dt_raw.float()).to(x.dtype)
    u = L.scale(tape, f"{scope}.a_neg", dt, p["a_neg.w"],
                param_path=f"{path}.a_neg.w")
    return z, xs, Bm, Cm, dt, u, new_tail


def _mamba_post(tape: Tape, scope: str, path: str, p: dict, y, xs, z, cfg):
    """The skip (``D``), the gate, the norm and the out-projection; y and xs
    (B, T, H, P) in the activation dtype, z (B, T, d_inner)."""
    B, T = y.shape[:2]
    xt = xs.reshape(B, T, cfg.nheads_ssm, cfg.ssm_head_dim).transpose(2, 3)
    dterm = L.scale(tape, f"{scope}.D", xt, p["D.w"],
                    param_path=f"{path}.D.w").transpose(2, 3)
    y = (y + dterm).reshape(B, T, cfg.d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    y = cm.rmsnorm(tape, f"{scope}.ssm_norm", y, cm.sub_params(p, "ssm_norm"),
                   path=f"{path}.ssm_norm")
    return L.dense(tape, f"{scope}.out_proj", y, p["out_proj.w"],
                   param_path=f"{path}.out_proj")


def mamba_block(tape: Tape, scope: str, path: str, p: dict, x,
                cfg: ArchConfig):
    """One mamba mixer on x (B, T, d_model); ``p`` holds its leaves
    (``in_proj.w``, ``conv.w`` ...)."""
    B, T, _ = x.shape
    H, P = cfg.nheads_ssm, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt, u, _ = _mamba_pre(tape, scope, path, p, x, cfg)
    y, _ = ssd_chunked(xs.reshape(B, T, H, P), dt, u, Bm, Cm, cfg.ssm_chunk)
    return _mamba_post(tape, scope, path, p, y.to(x.dtype), xs, z, cfg)


def mamba_decode(p: dict, x, cfg: ArchConfig, cache: dict, valid=None):
    """One mamba mixer over a decode step or a chunk of T >= 1 tokens x
    (B, T, d_model), the reference's ``mamba_decode``.  ``cache`` holds the
    layer's {"state" (B, H, N, P) f32, "conv" (B, K-1, C)}, written IN
    PLACE; ``valid`` (B, T) masks unconsumed chunk-tail tokens (their
    outputs are garbage the caller ignores).

    The recurrence is a loop of :func:`ssd_step` over the tokens, not the
    chunkwise scan: the reference's serving contract is a chunk equal to
    the same tokens decoded one at a time.  A masked token's step is the
    identity, as in the reference (its dt and decay are zeroed), and a row
    that consumes nothing writes its old state back through the mask
    (state + 0 would turn a -0.0 into +0.0), so it keeps its state and
    conv bit for bit."""
    B, T, _ = x.shape
    H, P = cfg.nheads_ssm, cfg.ssm_head_dim
    tape = Tape()
    z, xs, Bm, Cm, dt, u, tail = _mamba_pre(
        tape, "m", "-", p, x, cfg, conv_window=cache["conv"], valid=valid)
    if valid is not None:
        dt = torch.where(valid[..., None], dt, 0.0)
        u = torch.where(valid[..., None], u, 0.0)
    xf = xs.reshape(B, T, H, P).float()
    dtf, uf, Bf, Cf = dt.float(), u.float(), Bm.float(), Cm.float()
    state, ys = cache["state"], []
    for t in range(T):
        y_t, state = ssd_step(state, xf[:, t], dtf[:, t], uf[:, t],
                              Bf[:, t], Cf[:, t])
        ys.append(y_t)
    if valid is not None:
        state = torch.where(valid.any(dim=1)[:, None, None, None], state,
                            cache["state"])
    y = torch.stack(ys, dim=1).to(x.dtype)                  # (B, T, H, P)
    out = _mamba_post(tape, "m", "-", p, y, xs, z, cfg)
    cache["state"].copy_(state)
    cache["conv"].copy_(tail)
    return out


def mamba_cache(lead, B: int, cfg: ArchConfig, dtype, device) -> dict:
    """Zero mamba decode caches with leading axes ``lead`` (stacked
    layers): {"state" lead + (B, H, N, P) f32 whatever ``dtype``, "conv"
    lead + (B, K-1, d_inner + 2N) in ``dtype``}."""
    H, P, N = cfg.nheads_ssm, cfg.ssm_head_dim, cfg.ssm_state
    return {"state": torch.zeros(lead + (B, H, N, P), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros(lead + (B, cfg.conv_width - 1,
                                        cfg.d_inner + 2 * N),
                                dtype=dtype, device=device)}


class MambaLayers(nn.Module):
    """Residual mamba layers (``ln`` then the mixer), each leaf stacked on
    the leading axes ``lead``."""

    def __init__(self, lead, cfg: ArchConfig, gen, device):
        super().__init__()
        self.ln = cm.Leaf(torch.ones(lead + (cfg.d_model,), device=device))
        self.mamba = MambaParams(lead, cfg, gen, device)


def mamba_layer_body(cfg: ArchConfig, path: str):
    """scan_blocks' body for one residual mamba layer under ``path``."""
    def body(sub, p, x):
        h = cm.rmsnorm(sub, "ln", x, cm.sub_params(p, "ln"),
                       path=f"{path}.ln")
        return x + mamba_block(sub, "mamba", f"{path}.mamba",
                               cm.sub_params(p, "mamba"), h, cfg)
    return body


def mamba_decode_body(cfg: ArchConfig, valid):
    """scan_blocks' body for one residual mamba layer of a decode or chunk
    step: ``p`` holds the layer's leaves and, under ``cache.``, its slice
    of the decode cache."""
    def body(sub, p, x):
        h = cm.rmsnorm(sub, "ln", x, cm.sub_params(p, "ln"), path="-")
        return x + mamba_decode(cm.sub_params(p, "mamba"), h, cfg,
                                cm.sub_params(p, "cache"), valid)
    return body


class Mamba2LM(cm.DecodeSteps, cm.TokenLM):
    def _build(self, gen, device):
        self.blocks = MambaLayers((self.cfg.n_layers,), self.cfg, gen, device)
        self._block_leaves = cm.leaf_names(self.blocks)

    def _layers(self, tape: Tape, tokens: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        return scan_blocks(tape, "blocks", mamba_layer_body(self.cfg,
                                                            "blocks"),
                           cm.stacked_leaves(self.blocks, self._block_leaves),
                           x, self.cfg.n_layers)

    # -- serving: an O(1) state a slot, no KV cache -------------------------
    def init_cache(self, params: Dict[str, torch.Tensor], B: int, S: int,
                   dtype=torch.float32) -> dict:
        """Zero caches of ``B`` slots, one per layer, stacked: {"blocks":
        {"state" (n_layers, B, H, N, P) f32, "conv" (n_layers, B, K-1,
        d_inner + 2N) in ``dtype``}} on the params' device.  ``S`` is
        unused: nothing is indexed by position."""
        return {"blocks": mamba_cache((self.cfg.n_layers,), B, self.cfg,
                                      dtype, params["emb.w"].device)}

    def _decode_layers(self, params, cache, x, pos, valid):
        return scan_blocks(Tape(), "blocks",
                           mamba_decode_body(self.cfg, valid),
                           cm.with_cache(params, "blocks", cache["blocks"]),
                           x, self.cfg.n_layers)
