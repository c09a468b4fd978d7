"""The fused clipping engines, ``masked_fused`` and ``masked_fused_stream``.

``masked_fused`` takes the per-example grads exactly as ``masked_pe`` does
(``vmap(grad)`` at the whole physical batch, the same norms and
coefficients), lays them out as ONE (B, D) matrix in the flat accumulator
layout and hands the clipped masked sum to one launch of the ``clip_accum``
kernel.  The kernel folds the rows strictly left from +0, as ``masked_pe``
does, so the two engines are equal bit for bit.  Its peak memory is
O(B·params): the whole per-example tree exists when the kernel runs.

``masked_fused_stream`` never materialises that tree.  The
physical batch is cut into tiles of m examples; for each tile the engine
takes the tile's per-example grads (``vmap(grad)``, the ``masked_pe``
plumbing), concatenates them into an (m, D) tile in the flat accumulator
layout, and adds the tile's clipped masked sum STRAIGHT into the flat f32
accumulator, in place, through the ``clip_accum_inplace`` kernel.  Peak live
memory is O(m·params + params); ``m`` comes from ``DPConfig.stream_tile`` or
from :func:`~repro_torch.launch.costmodel.stream_tile_size` against the
device's free memory.

Norms come from each tile's own grads (the ``"pe"`` norm source, the
default) or, under :func:`set_stream_norm_source("ghost")
<set_stream_norm_source>`, from a full-batch ghost-norm pass first (no
per-example grads in the norm pass, a second backward for the tiles): the
literal two-pass form, which agrees with ``masked_pe`` to ghost-norm
tolerance, like ``masked_ghost``.

The reference vmaps an m=1 tile at width 2, because XLA gives the row of a
width-1 vmap other bits than the same row in a wider one and its bitwise
claim rests on every width giving the same row.  The port does not: in
PyTorch a row's gradient bits depend on the GEMM shape at EVERY width (a
width-2 row differs from the same row at width 8 on the CPU), so widening
m=1 would cost a second backward and buy no canonical bits.  The engine
equals ``masked_pe`` bitwise when the tile is the whole batch; otherwise it
equals bitwise the fold of the grads taken at its own tile width, and
differs from ``masked_pe`` by the grads' width dependence, which bf16
activations raise from f32 to bf16 rounding (``PERF.md``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels import flat_clip_accum, tree_clip_accum
from ..launch.costmodel import free_memory_bytes, stream_tile_size
from ..utils.params import FlatGradView
from .clipping import (clip_coef, ghost_norms, per_example_grads_and_sq,
                       register_engine)


@register_engine("masked_fused", materializes_pe=True)
def fused_clipped_grads(loss_fn: Callable, params, batch, mask,
                        clip_norm: float):
    grads, sq = per_example_grads_and_sq(loss_fn, params, batch)
    # the kernel recomputes mask * min(1, C/norm) itself; coef is aux
    coef, norms = clip_coef(sq, mask, clip_norm)
    summed = tree_clip_accum(grads, norms, mask.float(), clip_norm,
                             FlatGradView.for_params(params))
    return summed, {"per_example_norms": norms, "clip_coef": coef}


# where the streaming engine's per-example norms come from:
#   "pe"    — each tile's own vmapped grads (one backward in all; the
#             masked_pe numerics), the default;
#   "ghost" — a full-batch ghost-norm pass first, then the tiled
#             clip-and-accumulate backward with those coefficients
_NORM_SOURCES = ("pe", "ghost")
_stream_norm_source = "pe"


def set_stream_norm_source(source: str) -> str:
    """Switch the streaming engine's norm pass; returns the previous value
    (restore it in a ``finally:``)."""
    global _stream_norm_source
    if source not in _NORM_SOURCES:
        raise ValueError(f"norm source {source!r}; expected {_NORM_SOURCES}")
    prev = _stream_norm_source
    _stream_norm_source = source
    return prev


@register_engine("masked_fused_stream", streaming=True)
def streaming_clipped_grads(loss_fn: Callable, params, batch, mask,
                            clip_norm: float, *, acc=None,
                            view: Optional[FlatGradView] = None,
                            tile: Optional[int] = None):
    """Clip-and-accumulate per-example grads without the O(B·params) tree.

    With ``acc`` (the step builder's call) the flat accumulator is updated
    in place and returned; without it the engine starts from zeros and
    returns the summed gradient dict like every other engine."""
    standalone = acc is None
    if view is None:
        view = FlatGradView.for_params(params)
    device = mask.device
    if acc is None:
        acc = view.zeros(device)
    B = int(mask.shape[0])
    m = int(tile) if tile else stream_tile_size(B, view.n_params,
                                                  free_memory_bytes(device))
    m = max(1, min(m, B))

    # pad the batch to a tile multiple by repeating example 0 with mask 0:
    # coef = 0 exactly, so padded rows add exact zeros
    pad = (-B) % m
    if pad:
        batch = {k: torch.cat([v] + [v[:1]] * pad) for k, v in batch.items()}
        mask = torch.cat([mask, mask.new_zeros(pad)])
    ghost = _stream_norm_source == "ghost"
    if ghost:
        # pass 1: full-batch per-example norms with NO per-example grads
        sq_all, _ = ghost_norms(loss_fn, params, batch)
        pre_coef, pre_norms = clip_coef(sq_all, mask, clip_norm)
    pad_d = view.total - view.n_params
    norms_all, coefs_all = [], []
    for start in range(0, B + pad, m):
        sl = slice(start, start + m)
        grads, sq = per_example_grads_and_sq(
            loss_fn, params, {k: v[sl] for k, v in batch.items()})
        mk = mask[sl]
        if ghost:
            coef, norms = pre_coef[sl], pre_norms[sl]
        else:
            coef, norms = clip_coef(sq, mk, clip_norm)
        # the (m, D) tile in the accumulator's layout: the TILE is padded
        # over the alignment tail, the accumulator never is
        parts = [grads.pop(n).reshape(m, -1) for n in view.names]
        if pad_d:
            parts.append(parts[0].new_zeros(m, pad_d))
        tile_flat = torch.cat(parts, dim=1)
        del parts
        flat_clip_accum(acc, tile_flat, norms, mk.float(), clip_norm)
        del tile_flat
        norms_all.append(norms)
        coefs_all.append(coef)
    aux = {"per_example_norms": torch.cat(norms_all)[:B],
           "clip_coef": torch.cat(coefs_all)[:B]}
    if standalone:
        return view.unflatten(acc), aux
    return acc, aux
