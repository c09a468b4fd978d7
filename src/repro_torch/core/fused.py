"""The streaming fused clipping engine, ``masked_fused_stream``.

It never materialises the O(B·params) per-example gradient tree.  The
physical batch is cut into tiles of m examples; for each tile the engine
takes the tile's per-example grads (``vmap(grad)``, the ``masked_pe``
plumbing), concatenates them into an (m, D) tile in the flat accumulator
layout, and adds the tile's clipped masked sum STRAIGHT into the flat f32
accumulator, in place, through the ``clip_accum_inplace`` kernel.  Peak live
memory is O(m·params + params); ``m`` comes from ``DPConfig.stream_tile`` or
from :func:`~repro_torch.launch.costmodel.stream_tile_size` against the
device's free memory.

Norms come from each tile's own grads (the reference's ``"pe"`` norm
source; its ``"ghost"`` source arrives with the ghost-norm kernel).

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

from ..kernels import flat_clip_accum
from ..launch.costmodel import free_memory_bytes, stream_tile_size
from ..utils.params import FlatGradView
from .clipping import clip_coef, per_example_grads_and_sq, register_engine


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
    pad_d = view.total - view.n_params
    norms_all, coefs_all = [], []
    for start in range(0, B + pad, m):
        sl = slice(start, start + m)
        grads, sq = per_example_grads_and_sq(
            loss_fn, params, {k: v[sl] for k, v in batch.items()})
        mk = mask[sl]
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
