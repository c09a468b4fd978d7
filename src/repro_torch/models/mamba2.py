"""Mamba2 (SSD, state-space duality; Dao & Gu 2024) as an ``nn.Module``:
the reference's ``models/mamba2.py``, training only (the decode cache,
``mamba_decode`` and the serving steps wait for ROADMAP queue 1, item 7).

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
"""
from __future__ import annotations

import math

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


def _mamba_pre(tape: Tape, scope: str, path: str, p: dict, x, cfg):
    """The projection, conv and gating prologue (the reference's training
    branch, no conv window).  Returns (z, xs, Bm, Cm, dt, u)."""
    di, H, N = cfg.d_inner, cfg.nheads_ssm, cfg.ssm_state
    zxbcdt = L.dense(tape, f"{scope}.in_proj", x, p["in_proj.w"],
                     param_path=f"{path}.in_proj")
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt_raw = zxbcdt[..., -H:]
    xbc_c = L.conv1d_depthwise(tape, f"{scope}.conv", xbc, p["conv.w"],
                               param_path=f"{path}.conv.w")
    xbc_c = F.silu(xbc_c.float()).to(x.dtype)
    xs, Bm, Cm = xbc_c[..., :di], xbc_c[..., di:di + N], xbc_c[..., di + N:]
    dt_raw = L.bias(tape, f"{scope}.dt_bias", dt_raw, p["dt_bias.w"],
                    param_path=f"{path}.dt_bias.w")
    dt = F.softplus(dt_raw.float()).to(x.dtype)
    u = L.scale(tape, f"{scope}.a_neg", dt, p["a_neg.w"],
                param_path=f"{path}.a_neg.w")
    return z, xs, Bm, Cm, dt, u


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
    z, xs, Bm, Cm, dt, u = _mamba_pre(tape, scope, path, p, x, cfg)
    y, _ = ssd_chunked(xs.reshape(B, T, H, P), dt, u, Bm, Cm, cfg.ssm_chunk)
    return _mamba_post(tape, scope, path, p, y.to(x.dtype), xs, z, cfg)


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


class Mamba2LM(cm.TokenLM):
    def _build(self, gen, device):
        self.blocks = MambaLayers((self.cfg.n_layers,), self.cfg, gen, device)
        self._block_leaves = cm.leaf_names(self.blocks)

    def _layers(self, tape: Tape, tokens: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        return scan_blocks(tape, "blocks", mamba_layer_body(self.cfg,
                                                            "blocks"),
                           cm.stacked_leaves(self.blocks, self._block_leaves),
                           x, self.cfg.n_layers)
