"""DP-SGD core of the port: engines, step builders and the session."""
from . import clipping, fused  # noqa: F401  (fused registers its engines)
from .engine import (DPConfig, TrainState, build_accumulate_fn,
                     build_eval_fn, build_fused_step, build_update_fn,
                     fused_sgd, init_state)

__all__ = ["DPConfig", "TrainState", "build_accumulate_fn", "build_eval_fn",
           "build_fused_step", "build_update_fn", "clipping", "fused_sgd",
           "init_state"]
