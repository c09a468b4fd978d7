"""Clipped per-example gradient computation behind an engine registry.

Every engine maps
    (loss_fn, params, batch, mask, clip_norm)  ->
    (sum of clipped masked per-example grads, aux metrics)
where ``loss_fn(params, batch, tape=None) -> (B,)`` per-example losses,
``params`` is the port's ``{path: tensor}`` dict and ``mask`` the Poisson
0/1 mask of Algorithm 2.  As in the reference package's
``core/clipping.py``:

  * pe / masked_pe — ``torch.func.vmap`` over ``torch.func.grad``:
                     materialises per-example grads; the oracle every other
                     engine is held against.  It runs no kernel.
  * masked_ghost   — two passes: the eps-backward for per-example norms
                     (ghost trick), then a reweighted standard backward.  No
                     per-example parameter gradient ever exists.
  * masked_bk      — one pass: the eps-backward's (X, dY) tape is reused to
                     form the clipped summed grads analytically (Bu et al.).

(``masked_fused`` and ``masked_fused_stream`` live in :mod:`.fused`.)
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..kernels.clip_accum import clip_coefs
from ..utils.params import grads_into_tree, missing_paths, path_key
from . import layers
from .tape import Tape

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


def register_engine(name: str, *aliases: str, materializes_pe: bool = False,
                    record_based: bool = False, streaming: bool = False):
    """Decorator: register a clipping engine under ``name`` (+ aliases).

    Traits, as in the reference (``PrivacySession.describe`` reports them):
      materializes_pe — the engine builds real (B x params) per-example
                        gradient buffers;
      record_based    — its backward keeps per-layer (X, dY) records (ghost
                        and book-keeping);
      streaming       — it adds straight into the flat f32 accumulator: the
                        step builder calls it with ``acc=<flat buffer>,
                        view=<FlatGradView>, tile=<m or None>`` and gets
                        ``(new flat accumulator, aux)`` back."""
    def deco(fn):
        fn.materializes_pe = materializes_pe
        fn.record_based = record_based
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


@register_engine("pe", "masked_pe", materializes_pe=True)
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


def per_example_grad_norms(loss_fn: Callable, params, batch) -> torch.Tensor:
    """Oracle per-example grad norms (B,), used by tests."""
    return torch.sqrt(per_example_grads_and_sq(loss_fn, params, batch)[1])


# ---------------------------------------------------------------------------
# the eps-backward shared by ghost and book-keeping
# ---------------------------------------------------------------------------

def _eps_backward(loss_fn: Callable, params, batch):
    """One backward pass with respect to the eps injected at every
    primitive's output, with detached params (no parameter grad is built).

    Returns (dEps, records, specs, losses): per-example output grads in the
    activation dtype, the recorded inputs, the layer specs (in the tape's
    insertion order) and the per-example losses."""
    tape = Tape(Tape.RECORD)
    losses = loss_fn({k: v.detach() for k, v in params.items()}, batch, tape)
    leaves = [leaf for e in tape.eps.values() for leaf in _flat(e)]
    grads = torch.autograd.grad(losses.sum(), leaves, allow_unused=True)
    grads = iter(torch.zeros_like(leaf) if g is None else g
                 for leaf, g in zip(leaves, grads))
    # a layer stack's dY stay (nested) lists of the per-layer tensors, as
    # its records
    dEps = {n: _like(e, grads) for n, e in tape.eps.items()}
    return dEps, tape.records, tape.specs, losses.detach()


def _flat(e):
    """The tensors of a (nested) list of eps leaves, in order."""
    return [x for v in e for x in _flat(v)] if isinstance(e, list) else [e]


def _like(e, values):
    """``e``'s list nesting filled from the iterator ``values``."""
    return [_like(v, values) for v in e] if isinstance(e, list) \
        else next(values)


def _sq_norms(dEps, records, specs, batch_size: int, device):
    """Per-example squared norms summed over the specs in tape order."""
    sq = torch.zeros(batch_size, dtype=torch.float32, device=device)
    for name, spec in specs.items():
        rec = layers.resolve_record(records, name, spec)
        sq = sq + layers.per_example_sq_norm(spec, rec, dEps[name])
    return sq


def ghost_norms(loss_fn: Callable, params, batch):
    """Per-example grad squared norms via the ghost trick (no per-example
    grads); returns (sq, losses)."""
    dEps, records, specs, losses = _eps_backward(loss_fn, params, batch)
    return _sq_norms(dEps, records, specs, losses.shape[0],
                     losses.device), losses


@register_engine("masked_ghost", record_based=True)
def ghost_clipped_grads(loss_fn: Callable, params, batch, mask,
                        clip_norm: float) -> Tuple[dict, Aux]:
    """Ghost clipping: the norm pass, then a second backward over params of
    the coefficient-weighted loss (the coefficients detached)."""
    sq, _ = ghost_norms(loss_fn, params, batch)
    coef, norms = clip_coef(sq, mask, clip_norm)
    coef = coef.detach()

    def reweighted(p):
        return (coef * loss_fn(p, batch)).sum()

    summed = torch.func.grad(reweighted)(params)
    return ({k: v.float() for k, v in summed.items()},
            {"per_example_norms": norms, "clip_coef": coef})


@register_engine("masked_bk", record_based=True)
def bk_clipped_grads(loss_fn: Callable, params, batch, mask,
                     clip_norm: float, check_coverage: bool = False
                     ) -> Tuple[dict, Aux]:
    """Book-Keeping: one backward pass; the clipped grads are rebuilt from
    the tape.  ``check_coverage`` raises if a parameter has no BK grad."""
    dEps, records, specs, losses = _eps_backward(loss_fn, params, batch)
    sq = _sq_norms(dEps, records, specs, losses.shape[0], losses.device)
    coef, norms = clip_coef(sq, mask, clip_norm)
    flat: Dict[str, torch.Tensor] = {}
    for name, spec in specs.items():
        rec = layers.resolve_record(records, name, spec)
        for path, g in layers.bk_grads(spec, rec, dEps[name], coef).items():
            flat[path] = flat[path] + g if path in flat else g
    if check_coverage:
        miss = missing_paths(flat, params)
        if miss:
            raise ValueError(f"BK grads missing for params: {miss}")
    return (grads_into_tree(flat, params),
            {"per_example_norms": norms, "clip_coef": coef})
