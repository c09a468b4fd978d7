"""Models of the port (ViT, the dense decoder LM)."""
from .registry import ARCH_IDS, build, get_config
from .transformer import DenseLM
from .vit import ViT

__all__ = ["ARCH_IDS", "DenseLM", "ViT", "build", "get_config"]
