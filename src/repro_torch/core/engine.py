"""The DP step builders: DP-SGD steps with virtual batching (Algorithms 1
and 2), as in the reference package's ``core/engine.py``.

* ``accumulate``: ONE fixed-size physical batch — per-example clip (by the
  configured engine) with the Poisson 0/1 mask, added into the flat f32
  accumulator ``TrainState.grad_acc`` (layout:
  :class:`~repro_torch.utils.params.FlatGradView`); with
  ``DPConfig.microbatches`` = m the batch goes through the engine in m
  chunks, each added into the same accumulator.
* ``update``: once per logical batch — N(0, (σC)²) noise, divide by the
  EXPECTED logical batch size L, apply the optimizer, reset the
  accumulator.  Plain and momentum SGD are one launch of the fused
  ``noisy_sgd_update`` kernel over every leaf; Nesterov, AdamW and
  ``fuse=False`` take the generic path: one launch of the kernel's
  noise-only body (the same stream), then the optimizer's own update.

The port runs eagerly and updates in place: params, optimizer state and the
accumulator are rewritten, not copied, and the step functions mutate and
return the state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..kernels import tree_noise, tree_noisy_update
from ..kernels.noisy_update import step_seeds, update_scalars
from ..optim import Optimizer
from ..utils.params import FlatGradView
from . import clipping


@dataclasses.dataclass(frozen=True)
class DPConfig:
    clip_norm: float = 1.0
    noise_multiplier: float = 1.0        # sigma
    expected_batch_size: float = 64.0    # L = q * N
    # masked_pe | masked_fused | masked_fused_stream | masked_ghost |
    # masked_bk | nonprivate
    engine: str = "masked_pe"
    microbatches: int = 1                # in-step chunks of the physical batch
    stream_tile: Optional[int] = None    # streaming: examples per tile m;
    #                                      None = sized from free memory

    @property
    def private(self) -> bool:
        return self.engine != "nonprivate"

    def validate(self) -> "DPConfig":
        """Raise (with the registered-engine list) on an unknown engine."""
        if self.private:
            clipping.resolve_engine(self.engine)
        return self


@dataclasses.dataclass
class TrainState:
    params: dict                  # {path: f32 tensor}
    opt_state: dict               # {"count": int, flat f32 buffers}
    grad_acc: torch.Tensor        # flat f32 (D,), FlatGradView layout
    rng: Tuple[int, int]          # the noise key: two uint32 words
    step: int = 0                 # optimizer steps taken
    seen: Optional[torch.Tensor] = None   # masked examples since the update


def fused_sgd(optimizer: Optimizer) -> bool:
    """True when the optimizer's update is the fused single-pass kernel
    (plain or momentum SGD); Nesterov and AdamW take the generic path."""
    return (optimizer.kind == "sgd" and isinstance(optimizer.hyper, dict)
            and not optimizer.hyper.get("nesterov", False))


def init_state(params, optimizer: Optimizer, rng: Tuple[int, int]
               ) -> TrainState:
    view = FlatGradView.for_params(params)
    device = next(iter(params.values())).device
    return TrainState(params=params,
                      opt_state=optimizer.init(view, device),
                      grad_acc=view.zeros(device), rng=rng, step=0,
                      seen=torch.zeros((), dtype=torch.float32,
                                       device=device))


def _microbatched_clipped_sum(engine, loss_fn, params, batch, mask,
                              cfg: DPConfig, acc, view):
    """The physical batch through the engine in ``cfg.microbatches`` chunks
    (one by default), each chunk's clipped sum added into ``acc`` in turn
    (bounds the live per-example state, as the reference's in-step scan
    does)."""
    m = cfg.microbatches
    B = int(mask.shape[0])
    if B % m:
        raise ValueError(f"physical batch {B} is not a multiple of "
                         f"microbatches={m}")
    n = B // m
    norms, coefs = [], []
    for i in range(m):
        sl = slice(i * n, (i + 1) * n)
        g, aux = engine(loss_fn, params, {k: v[sl] for k, v in batch.items()},
                        mask[sl], cfg.clip_norm)
        acc.add_(view.flatten(g))
        del g
        norms.append(aux["per_example_norms"])
        coefs.append(aux["clip_coef"])
    return {"per_example_norms": torch.cat(norms),
            "clip_coef": torch.cat(coefs)}


def build_accumulate_fn(loss_fn: Callable, cfg: DPConfig, *,
                        stream_tile: Optional[Callable[[int], int]] = None):
    """accumulate(state, batch, mask) -> (state, metrics).

    ``stream_tile``, a function of the physical batch size, gives a
    streaming engine its tile when ``cfg.stream_tile`` is None (the session
    sizes it once, so every step folds at the same width)."""
    engine = clipping.resolve_engine(cfg.engine) if cfg.private else None
    streaming = engine is not None and engine.streaming
    if streaming and cfg.microbatches > 1:
        raise ValueError(
            f"engine {cfg.engine!r} streams tile-by-tile into the flat "
            f"accumulator; the stream_tile IS the in-step microbatch, so "
            f"cfg.microbatches must stay 1 (got {cfg.microbatches})")

    def _dp_metrics(aux, mask):
        norms = aux["per_example_norms"]
        seen = torch.clamp_min(mask.sum(), 1)
        return {"mean_grad_norm": (norms * mask).sum() / seen,
                "max_grad_norm": (norms * mask).max(),
                "clip_fraction": ((norms > cfg.clip_norm) * mask).sum()
                / seen}

    def accumulate(state: TrainState, batch, mask):
        mask = mask.float()
        view = FlatGradView.for_params(state.params)
        if streaming:
            tile = cfg.stream_tile
            if tile is None and stream_tile is not None:
                tile = stream_tile(int(mask.shape[0]))
            _, aux = engine(loss_fn, state.params, batch, mask,
                            cfg.clip_norm, acc=state.grad_acc, view=view,
                            tile=tile)
            metrics = _dp_metrics(aux, mask)
        elif cfg.private:
            aux = _microbatched_clipped_sum(engine, loss_fn, state.params,
                                            batch, mask, cfg,
                                            state.grad_acc, view)
            metrics = _dp_metrics(aux, mask)
        else:
            # the masked SUM of per-example losses: the update divides once
            # by the total seen count
            def sum_loss(p):
                return (loss_fn(p, batch) * mask).sum()
            state.grad_acc.add_(view.flatten(torch.func.grad(sum_loss)(
                state.params)))
            metrics = {}
        state.seen = state.seen + mask.sum()
        return state, metrics

    return accumulate


def build_update_fn(optimizer: Optimizer, cfg: DPConfig, *,
                    fuse: bool = True):
    """update(state, noise=None) -> state: noise + optimizer step, then
    reset the accumulator.

    Plain and momentum SGD go through the fused kernel, which draws the
    noise from the step's seed words
    (:func:`~repro_torch.kernels.noisy_update.step_seeds`).  Nesterov,
    AdamW and ``fuse=False`` take the generic path: the kernel's noise-only
    body writes the same stream into a flat buffer
    (:func:`~repro_torch.kernels.tree_noise`), the noisy gradient is formed
    in the accumulator with the kernel's rounded ops in its order
    (``(acc + σC·z) · (1/L)``), and ``optimizer.update`` applies it.  For
    momentum SGD the two paths give the same bits.

    ``noise``, a flat N(0,1) tensor in the accumulator's layout, replaces
    the draw — used to replay the reference's noise in parity checks."""
    fused = fuse and fused_sgd(optimizer)

    def update(state: TrainState, noise: Optional[torch.Tensor] = None):
        view = FlatGradView.for_params(state.params)
        sigma_c = cfg.noise_multiplier * cfg.clip_norm
        count = state.opt_state["count"]
        if cfg.private:
            seeds = step_seeds(state.rng, state.step) if noise is None \
                else None
            denom = cfg.expected_batch_size
        else:
            if noise is not None:
                raise ValueError("a non-private update takes no noise")
            seeds, denom = None, max(float(state.seen), 1.0)
        acc = state.grad_acc
        if fused:
            hyper = optimizer.hyper
            tree_noisy_update(state.params, acc, seeds, sigma_c, denom,
                              hyper["lr"](count), view=view,
                              momentum_buf=state.opt_state["mom"],
                              momentum=hyper["momentum"], noise=noise)
        else:
            sc, inv_l, _, _ = update_scalars(sigma_c, denom, 0.0, 0.0)
            if cfg.private:
                if noise is None:
                    z = tree_noise(state.params, seeds, view=view).mul_(sc)
                else:
                    z = noise * sc
                acc.add_(z)                    # acc + sc * z, each rounded
                del z
            acc.mul_(inv_l)                    # the noisy gradient, in place
            optimizer.update(acc, state.opt_state, state.params, view)
        if fused:
            state.opt_state["count"] = count + 1
        acc.zero_()
        state.step += 1
        state.seen = torch.zeros_like(state.seen)
        return state

    return update


def build_fused_step(loss_fn: Callable, optimizer: Optimizer,
                     cfg: DPConfig):
    """One logical batch == one call: clip+accumulate then noise+update."""
    accumulate = build_accumulate_fn(loss_fn, cfg)
    update = build_update_fn(optimizer, cfg)

    def step(state: TrainState, batch, mask, noise=None):
        state, metrics = accumulate(state, batch, mask)
        return update(state, noise), metrics

    return step


def build_eval_fn(loss_fn: Callable):
    def evaluate(params, batch, mask):
        with torch.no_grad():
            losses = loss_fn(params, batch)
            return (losses * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return evaluate
