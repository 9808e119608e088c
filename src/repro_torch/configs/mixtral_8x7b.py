"""Mixtral-8x7B — sparse MoE decoder [arXiv:2401.04088; hf]."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    rope_theta=1e6,
    sliding_window=4096,
    source="arXiv:2401.04088",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        n_experts=4,
        experts_per_token=2,
        sliding_window=0,
    )
