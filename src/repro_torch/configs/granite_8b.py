"""Granite-8B-Code — llama-arch dense decoder [arXiv:2405.04324; hf]."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    tie_embeddings=True,
    source="arXiv:2405.04324",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=384,
    )
