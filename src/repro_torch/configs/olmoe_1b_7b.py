"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,          # per-expert FFN width
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    source="arXiv:2409.02060",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        n_experts=8,
        experts_per_token=2,
    )
