"""The port's Hopper kernels, each beside its plain PyTorch version.

(The resident ``clip_accum`` is reached as ``kernels.clip_accum.clip_accum``:
exporting it here would shadow its module.)"""
from .clip_accum import clip_accum_inplace, flat_clip_accum, tree_clip_accum
from .ghost_norm import ghost_norm_dense
from .noisy_update import noisy_sgd_update, tree_noisy_update

__all__ = ["clip_accum_inplace", "flat_clip_accum", "ghost_norm_dense",
           "noisy_sgd_update", "tree_clip_accum", "tree_noisy_update"]
