"""Architecture registry: name -> ArchConfig, family -> model class.

The port builds every family of the reference: ``vit``, ``dense``,
``ssm`` (Mamba2), ``hybrid`` (Zamba2), ``moe`` (``DeepseekV2LM`` when the
config has an MLA latent, ``kv_lora``, else ``MoeLM``, as the reference's
``_family_cls`` chooses), ``audio`` (``WhisperLM``) and ``vlm``
(``VisionLM``); an unknown family raises.
"""
from __future__ import annotations

from ..configs import ArchConfig, get_config
from .mamba2 import Mamba2LM
from .mla import DeepseekV2LM
from .moe import MoeLM
from .transformer import DenseLM
from .vit import ViT
from .vlm import VisionLM
from .whisper import WhisperLM
from .zamba2 import Zamba2LM

__all__ = ["ARCH_IDS", "build", "get_config"]

# the reference's architectures; get_config finds each
ARCH_IDS = [
    "olmoe-1b-7b", "llama-3.2-vision-90b", "deepseek-67b",
    "deepseek-v2-lite-16b", "qwen2-0.5b", "zamba2-1.2b", "qwen3-1.7b",
    "mamba2-1.3b", "whisper-base", "llama3.2-3b", "vit-base",
]


def _moe(cfg: ArchConfig, *, device, seed: int):
    """The MoE family's model: ``DeepseekV2LM`` when the config has an MLA
    latent, else ``MoeLM``."""
    cls = DeepseekV2LM if cfg.kv_lora else MoeLM
    return cls(cfg, device=device, seed=seed)


_FAMILIES = {"vit": ViT, "dense": DenseLM, "ssm": Mamba2LM,
             "hybrid": Zamba2LM, "moe": _moe, "audio": WhisperLM,
             "vlm": VisionLM}


def build(cfg: ArchConfig, *, device, seed: int = 0):
    """The model of ``cfg``'s family on ``device``, initialised from
    ``seed``."""
    cls = _FAMILIES.get(cfg.family)
    if cls is None:
        raise ValueError(f"unknown model family {cfg.family!r}; the port "
                         f"builds {sorted(_FAMILIES)}")
    return cls(cfg, device=device, seed=seed)
