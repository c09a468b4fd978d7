"""The DP step builders: DP-SGD steps with virtual batching (Algorithms 1
and 2), as in the reference package's ``core/engine.py``.

* ``accumulate``: ONE fixed-size physical batch — per-example clip (by the
  configured engine) with the Poisson 0/1 mask, added into the flat f32
  accumulator ``TrainState.grad_acc`` (layout:
  :class:`~repro_torch.utils.params.FlatGradView`).
* ``update``: once per logical batch — N(0, (σC)²) noise, divide by the
  EXPECTED logical batch size L, momentum SGD, over every leaf in one
  launch of the ``noisy_sgd_update`` kernel; then the accumulator is reset.

The port runs eagerly and updates in place: params, momentum and the
accumulator are rewritten, not copied, and the step functions mutate and
return the state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..kernels import tree_noisy_update
from ..kernels.noisy_update import step_seeds
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
    opt_state: dict               # {"count": int, "mom": flat f32 or None}
    grad_acc: torch.Tensor        # flat f32 (D,), FlatGradView layout
    rng: Tuple[int, int]          # the noise key: two uint32 words
    step: int = 0                 # optimizer steps taken
    seen: Optional[torch.Tensor] = None   # masked examples since the update


def init_state(params, optimizer: Optimizer, rng: Tuple[int, int]
               ) -> TrainState:
    view = FlatGradView.for_params(params)
    device = next(iter(params.values())).device
    mom = view.zeros(device) if optimizer.momentum else None
    return TrainState(params=params, opt_state={"count": 0, "mom": mom},
                      grad_acc=view.zeros(device), rng=rng, step=0,
                      seen=torch.zeros((), dtype=torch.float32,
                                       device=device))


def build_accumulate_fn(loss_fn: Callable, cfg: DPConfig):
    """accumulate(state, batch, mask) -> (state, metrics)."""
    engine = clipping.resolve_engine(cfg.engine) if cfg.private else None
    streaming = engine is not None and engine.streaming

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
            _, aux = engine(loss_fn, state.params, batch, mask,
                            cfg.clip_norm, acc=state.grad_acc, view=view,
                            tile=cfg.stream_tile)
            metrics = _dp_metrics(aux, mask)
        elif cfg.private:
            g, aux = engine(loss_fn, state.params, batch, mask,
                            cfg.clip_norm)
            state.grad_acc.add_(view.flatten(g))
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


def build_update_fn(optimizer: Optimizer, cfg: DPConfig):
    """update(state, noise=None) -> state: noise + SGD(+momentum) through
    the fused kernel, then reset the accumulator.

    The noise is drawn in the kernel from the step's seed words
    (:func:`~repro_torch.kernels.noisy_update.step_seeds`).  ``noise``, a
    flat N(0,1) tensor in the accumulator's layout, replaces that draw —
    used to replay the reference's noise in parity checks."""

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
        tree_noisy_update(state.params, state.grad_acc, seeds, sigma_c,
                          denom, optimizer.lr(count), view=view,
                          momentum_buf=state.opt_state["mom"],
                          momentum=optimizer.momentum, noise=noise)
        state.opt_state["count"] = count + 1
        state.grad_acc.zero_()
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
