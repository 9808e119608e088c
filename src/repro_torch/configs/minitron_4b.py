"""Minitron-4B — pruned Nemotron dense decoder [arXiv:2407.14679; hf]."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    source="arXiv:2407.14679",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
    )
