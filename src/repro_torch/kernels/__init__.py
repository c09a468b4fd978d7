"""The port's Hopper kernels, each beside its plain PyTorch version."""
from .clip_accum import clip_accum_inplace, flat_clip_accum
from .noisy_update import noisy_sgd_update, tree_noisy_update

__all__ = ["clip_accum_inplace", "flat_clip_accum", "noisy_sgd_update",
           "tree_noisy_update"]
