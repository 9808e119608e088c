"""Llama-3.2-Vision-90B backbone — cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision].  The vision frontend is a STUB:
``input_specs`` provides precomputed patch embeddings (per brief)."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_period=5,       # every 5th layer cross-attends to vision
    frontend_tokens=1601 * 4,  # 4 tiles of 1601 patch embeddings
    frontend_dim=8192,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        cross_attn_period=2,
        frontend_tokens=16,
        frontend_dim=64,
    )
