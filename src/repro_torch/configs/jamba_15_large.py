"""Jamba-1.5-Large (398B total / 94B active) — hybrid Mamba+attention
with MoE, attention every 8th layer, MoE every 2nd [arXiv:2403.19887]."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_layer_period=2,      # every other layer's FFN is MoE
    attn_layer_period=8,     # 1:7 attention:mamba interleave
    mamba_d_state=16,
    source="arXiv:2403.19887",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=4,            # keeps one attn + three mamba layers
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        n_experts=4,
        experts_per_token=2,
        attn_layer_period=4,
    )
