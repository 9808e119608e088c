"""Architecture configs of the port — one module per ported architecture."""
from .base import ARCH_IDS, ModelConfig, ShapeConfig, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "ModelConfig", "ShapeConfig", "get_config", "get_smoke_config"]
