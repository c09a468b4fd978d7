"""Models of the port (ViT, the dense decoder LM, Mamba2, Zamba2)."""
from .mamba2 import Mamba2LM
from .registry import ARCH_IDS, build, get_config
from .transformer import DenseLM
from .vit import ViT
from .zamba2 import Zamba2LM

__all__ = ["ARCH_IDS", "DenseLM", "Mamba2LM", "ViT", "Zamba2LM", "build",
           "get_config"]
