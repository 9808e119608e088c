"""Architecture configs of the port — one module per ported architecture."""
from .base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, get_config,
                   get_smoke_config, shape_by_name)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "get_smoke_config", "shape_by_name"]
