"""Learning-rate schedules: pure functions of the step counter, returning
the f32 value the reference's schedules return."""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant(lr: float):
    return lambda step: float(_f32(lr))


def cosine(lr: float, total_steps: int, final_frac: float = 0.0):
    def f(step):
        t = np.clip(_f32(step) / _f32(max(total_steps, 1)), _f32(0), _f32(1))
        c = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * t))
        return float(_f32(lr * (final_frac + (1 - final_frac) * float(c))))
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.0):
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        if step < warmup:
            return float(_f32(lr * min(step / max(warmup, 1), 1.0)))
        return cos(step - warmup)
    return f
