"""Synthetic datasets for training without downloads: token streams for the
LMs, precomputed frame/patch embeddings with a token stream for the
frontend families (audio, vlm), and labelled images for the paper's ViT
config.

numpy copies of the reference package's ``TokenDataset``,
``EmbeddingDataset`` and ``ImageDataset``: the same seed gives the same
tokens, frontends, images and labels.  Images stay NHWC, as the
reference's model reads them.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def dataset_for_config(cfg, n: int, seq_len: int, seed: int = 0):
    """The synthetic dataset for an ArchConfig's modality family: images for
    the ViT (``seq_len`` ignored), tokens for the dense, SSM, hybrid and
    MoE LMs, and frontend embeddings with ``seq_len`` decoder (audio) or
    text (vlm) tokens for the frontend families: ``n_audio_frames`` frames
    of ``d_model`` for audio, ``n_image_tokens`` patches of
    ``frontend_dim`` for the VLM.  An unknown family raises."""
    if cfg.family == "vit":
        return ImageDataset(n, size=cfg.image_size, classes=cfg.n_classes,
                            seed=seed)
    if cfg.family == "vlm":
        return EmbeddingDataset(n, frames=cfg.n_image_tokens,
                                dim=cfg.frontend_dim, seq_len=seq_len,
                                vocab=cfg.vocab, seed=seed)
    if cfg.family == "audio":
        return EmbeddingDataset(n, frames=cfg.n_audio_frames,
                                dim=cfg.d_model, seq_len=seq_len,
                                vocab=cfg.vocab, seed=seed)
    if cfg.family in ("dense", "ssm", "hybrid", "moe"):
        return TokenDataset(n, seq_len=seq_len, vocab=cfg.vocab, seed=seed)
    raise ValueError(f"unknown model family {cfg.family!r}")


@dataclasses.dataclass
class TokenDataset:
    """Deterministic synthetic LM corpus: (tokens, labels=next token)."""
    n: int
    seq_len: int
    vocab: int
    seed: int = 0

    def __post_init__(self):
        # each row is drawn from its own spawned stream, so a huge n costs
        # nothing until fetched
        self._root = np.random.SeedSequence(self.seed)

    def fetch(self, idx: np.ndarray) -> dict:
        toks = np.stack([self._row(int(i)) for i in idx])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def _row(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self._root.spawn_key + (i,))
        return rng.integers(0, self.vocab, self.seq_len + 1)


@dataclasses.dataclass
class EmbeddingDataset:
    """Precomputed modality-frontend embeddings (audio frames or image
    patches, f32 N(0, 1)) and the decoder's token stream: ``frontend``
    (n, frames, dim), ``tokens`` and ``labels`` (n, seq_len), each example
    from its own spawned stream."""
    n: int
    frames: int
    dim: int
    seq_len: int
    vocab: int
    seed: int = 0

    def __post_init__(self):
        self._root = np.random.SeedSequence(self.seed)

    def fetch(self, idx: np.ndarray) -> dict:
        embs, toks = [], []
        for i in idx:
            rng = np.random.default_rng(self._root.spawn_key + (int(i),))
            embs.append(rng.standard_normal((self.frames, self.dim),
                                            dtype=np.float32))
            toks.append(rng.integers(0, self.vocab, self.seq_len + 1))
        t = np.stack(toks)
        return {"frontend": np.stack(embs),
                "tokens": t[:, :-1].astype(np.int32),
                "labels": t[:, 1:].astype(np.int32)}


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
