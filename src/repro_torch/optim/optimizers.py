"""SGD (momentum, Nesterov) and AdamW over the flat DP gradient, as the
reference package's ``optim/optimizers.py``.

An :class:`Optimizer` is an ``(init, update)`` pair plus static metadata.
Its state lives in flat f32 buffers in the gradient accumulator's layout
(:class:`~repro_torch.utils.params.FlatGradView`): ``{"count", "mom"}`` for
SGD (``mom`` None without momentum), ``{"count", "mu", "nu"}`` for AdamW.
``update`` rewrites the state and the parameters IN PLACE.

``kind``/``hyper`` let ``build_update_fn`` recognise plain and momentum SGD,
whose update is one launch of the fused ``noisy_sgd_update`` kernel
(:func:`~repro_torch.core.engine.fused_sgd`); Nesterov, AdamW and
``fuse=False`` take the generic path, which calls ``update`` with the noisy
flat gradient.  SGD's ``update`` is written as the kernel's sequence of
separately rounded ops (``kernels/noisy_update.py``
``noisy_sgd_update_plain``), so the two paths give the same bits.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from .schedule import constant


class Optimizer(NamedTuple):
    """``init(view, device) -> state``;
    ``update(g, state, params, view) -> state`` with ``g`` the flat f32
    gradient (read only), ``params`` the ``{path: tensor}`` dict."""
    init: Callable
    update: Callable
    kind: str = ""           # "sgd" | "adamw" | "" (custom)
    hyper: dict = None       # static hyperparameters (lr schedule, ...)


def _sched(lr) -> Callable:
    return lr if callable(lr) else constant(lr)


def _f32(x) -> float:
    return float(np.float32(x))


def _apply(params: Dict[str, torch.Tensor], view, step: torch.Tensor,
           lr: float) -> None:
    """p <- p - lr * step, leaf by leaf: one rounded product, then the
    rounded difference (the kernel's ``__fsub_rn(p, __fmul_rn(lr, m))``)."""
    for i, name in enumerate(view.names):
        params[name].sub_(view.segment(step, i) * lr)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    lr = _sched(lr)
    hyper = {"lr": lr, "momentum": float(momentum), "nesterov": nesterov}

    def init(view, device):
        return {"count": 0,
                "mom": view.zeros(device) if momentum else None}

    def update(g, state, params, view):
        step_lr, mu = _f32(lr(state["count"])), _f32(momentum)
        use = g
        if momentum:
            m = state["mom"]
            m.mul_(mu).add_(g)                    # m <- mu * m + g
            use = m * mu + g if nesterov else m
        _apply(params, view, use, step_lr)
        state["count"] += 1
        return state

    return Optimizer(init, update, kind="sgd", hyper=hyper)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr = _sched(lr)
    hyper = {"lr": lr, "b1": b1, "b2": b2, "eps": eps,
             "weight_decay": weight_decay}

    def init(view, device):
        return {"count": 0, "mu": view.zeros(device),
                "nu": view.zeros(device)}

    def update(g, state, params, view):
        count = state["count"]
        step_lr = _f32(lr(count))
        c = np.float32(count + 1)
        mu, nu = state["mu"], state["nu"]
        mu.mul_(b1).add_(g * _f32(1 - b1))
        nu.mul_(b2).add_(g.square().mul_(_f32(1 - b2)))
        # the bias corrections in f32, as the reference computes them
        bc1 = _f32(np.float32(1) - np.float32(b1) ** c)
        bc2 = _f32(np.float32(1) - np.float32(b2) ** c)
        for i, name in enumerate(view.names):
            p = params[name]
            u = view.segment(mu, i) / bc1
            u.div_(view.segment(nu, i).div(bc2).sqrt_().add_(eps))
            if weight_decay:
                u.add_(p * _f32(weight_decay))
            p.sub_(u.mul_(step_lr))
        state["count"] = count + 1
        return state

    return Optimizer(init, update, kind="adamw", hyper=hyper)
