"""Clipped per-example gradient computation behind an engine registry.

Every engine maps
    (loss_fn, params, batch, mask, clip_norm)  ->
    (sum of clipped masked per-example grads, aux metrics)
where ``loss_fn(params, batch) -> (B,)`` per-example losses, ``params`` is
the port's ``{path: tensor}`` dict and ``mask`` the Poisson 0/1 mask of
Algorithm 2.  ``masked_pe`` (``torch.func.vmap`` over ``torch.func.grad``)
is the oracle every other engine is held against, as in the reference
package's ``core/clipping.py``.  It runs no kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..kernels.clip_accum import clip_coefs
from ..utils.params import path_key

Aux = Dict[str, torch.Tensor]


class EngineRegistry(dict):
    """Name -> engine mapping that fails with the available names listed."""

    def __getitem__(self, name):
        try:
            return super().__getitem__(name)
        except KeyError:
            raise KeyError(
                f"Unknown clipping engine {name!r}. Registered engines: "
                f"{available_engines()} (plus 'nonprivate' for the "
                f"unclipped baseline).") from None


ENGINES: "EngineRegistry" = EngineRegistry()


def register_engine(name: str, *aliases: str, streaming: bool = False):
    """Decorator: register a clipping engine under ``name`` (+ aliases).

    ``streaming`` engines add straight into the flat f32 accumulator; the
    step builder calls them with ``acc=<flat buffer>, view=<FlatGradView>,
    tile=<m or None>`` and gets ``(new flat accumulator, aux)`` back."""
    def deco(fn):
        fn.streaming = streaming
        for key in (name,) + aliases:
            if key in ENGINES and dict.__getitem__(ENGINES, key) is not fn:
                raise ValueError(f"clipping engine {key!r} already registered")
            ENGINES[key] = fn
        return fn
    return deco


def resolve_engine(name: str) -> Callable:
    """Look an engine up by name; raises KeyError listing the registry."""
    return ENGINES[name]


def available_engines() -> Tuple[str, ...]:
    return tuple(sorted(ENGINES))


def clip_coef(sq_norms, mask, clip_norm):
    """Opacus clip factor min(1, C/||g||), times the Poisson mask; returns
    ``(coef, norms)`` with ``norms = sqrt(max(sq, 1e-24))``.  The factor is
    the kernel's own :func:`~repro_torch.kernels.clip_accum.clip_coefs`
    (its ``max(norm, 1e-12)`` is the identity on these norms), so the
    oracle and the kernel round it the same way."""
    norms = torch.sqrt(torch.clamp_min(sq_norms, 1e-24))
    return clip_coefs(norms, mask, clip_norm), norms


def per_example_grads_and_sq(loss_fn: Callable, params, batch):
    """Per-example grads ``{path: (B, *shape)}`` by ``vmap(grad)`` and their
    per-example squared norms, summed over leaves in flatten order."""
    def one_loss(p, ex):
        return loss_fn(p, {k: v.unsqueeze(0) for k, v in ex.items()})[0]

    grads = torch.func.vmap(torch.func.grad(one_loss),
                            in_dims=(None, 0))(params, batch)
    sq = sum((grads[n].reshape(grads[n].shape[0], -1).float() ** 2).sum(-1)
             for n in sorted(grads, key=path_key))
    return grads, sq


@register_engine("pe", "masked_pe")
def per_example_clipped_grads(loss_fn: Callable, params, batch, mask,
                              clip_norm: float) -> Tuple[dict, Aux]:
    grads, sq = per_example_grads_and_sq(loss_fn, params, batch)
    coef, norms = clip_coef(sq, mask, clip_norm)
    summed = {}
    for name, g in grads.items():
        # strict left fold over the example axis from +0 — the CANONICAL
        # reduction order the streaming kernel reproduces bitwise; each
        # weight is rounded before its add (no multiply-add)
        out = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
        for b in range(g.shape[0]):
            out = out + g[b].float() * coef[b]
        summed[name] = out
    return summed, {"per_example_norms": norms, "clip_coef": coef}
