"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892]."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # wkv heads of size 64
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attention_free=True,
    source="arXiv:2404.05892",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
    )
