"""Models of the port (ViT)."""
from .vit import ViT, build

__all__ = ["ViT", "build"]
