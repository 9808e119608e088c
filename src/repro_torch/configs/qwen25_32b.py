"""Qwen2.5-32B — dense decoder, GQA, QKV bias [hf:Qwen/Qwen2.5-*]."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=80,
        n_heads=5,
        n_kv_heads=1,
        d_ff=192,
        vocab_size=512,
    )
