"""SGD (with momentum) for the fused DP update.

The port's update is the fused ``noisy_sgd_update`` kernel, so an optimizer
here is its static description: the lr schedule and the momentum.  Its state is ``{"count": int, "mom": flat f32 buffer or
None}``, the momentum in the same flat layout as the gradient accumulator.
Adam-family optimizers and Nesterov are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from .schedule import constant


class Optimizer(NamedTuple):
    lr: Callable       # step -> f32 learning rate
    momentum: float    # 0 = plain SGD


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    return Optimizer(lr=lr if callable(lr) else constant(lr),
                     momentum=float(momentum))
