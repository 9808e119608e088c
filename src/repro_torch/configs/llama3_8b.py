"""Llama-3-8B — dense decoder, GQA, 128k vocab [arXiv:2407.21783]."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
    )
