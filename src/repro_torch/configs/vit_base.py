"""ViT-Base/16 @ 224 with a CIFAR-100 head — the paper's own benchmark
model (Dosovitskiy et al., 2021; Table 1 of the paper)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="vit-base", family="vit",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=0, image_size=224, patch=16, n_classes=100,
)
