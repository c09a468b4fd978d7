"""Architecture configs (jax-free dataclasses)."""
import importlib

from .base import ArchConfig

__all__ = ["ArchConfig", "get_config"]


def get_config(name: str) -> ArchConfig:
    """The ArchConfig of a ported architecture, by its registry name."""
    mod = importlib.import_module(
        f"{__name__}.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
