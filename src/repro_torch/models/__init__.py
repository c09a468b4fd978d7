"""Models of the port (ViT, the dense decoder LM, Mamba2, Zamba2, the MoE
LMs, Whisper, the cross-attention VLM)."""
from .mamba2 import Mamba2LM
from .mla import DeepseekV2LM
from .moe import MoeLM
from .registry import ARCH_IDS, build, get_config
from .transformer import DenseLM
from .vit import ViT
from .vlm import VisionLM
from .whisper import WhisperLM
from .zamba2 import Zamba2LM

__all__ = ["ARCH_IDS", "DeepseekV2LM", "DenseLM", "Mamba2LM", "MoeLM", "ViT",
           "VisionLM", "WhisperLM", "Zamba2LM", "build", "get_config"]
