"""Synthetic labelled images for the paper's ViT config (no downloads).

A numpy copy of the reference package's ``ImageDataset``: the same seed gives
the same images and labels.  Images stay NHWC, as the reference's model
reads them.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def dataset_for_config(cfg, n: int, seed: int = 0):
    """The synthetic dataset for an ArchConfig's modality family.  The port
    has the ViT family only."""
    if cfg.family == "vit":
        return ImageDataset(n, size=cfg.image_size, classes=cfg.n_classes,
                            seed=seed)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet; the port trains ViT")


@dataclasses.dataclass
class ImageDataset:
    """Synthetic CIFAR-100-at-224-like images for the paper's ViT config."""
    n: int
    size: int = 224
    channels: int = 3
    classes: int = 100
    seed: int = 0

    def __post_init__(self):
        self._root = np.random.SeedSequence(self.seed)

    def fetch(self, idx: np.ndarray) -> dict:
        xs, ys = [], []
        for i in idx:
            rng = np.random.default_rng(self._root.spawn_key + (int(i),))
            xs.append(rng.standard_normal(
                (self.size, self.size, self.channels)).astype(np.float32))
            ys.append(rng.integers(0, self.classes))
        return {"image": np.stack(xs), "label": np.array(ys, np.int32)}
