"""Model stack of the port: the dense GQA decoder ``LM``."""
from .transformer import LM, LayerSpec

__all__ = ["LM", "LayerSpec"]
