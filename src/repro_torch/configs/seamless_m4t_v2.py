"""SeamlessM4T-large-v2 backbone — encoder-decoder, multimodal
[arXiv:2308.11596].  The speech frontend is a STUB: ``input_specs``
provides precomputed frame embeddings (per brief)."""
from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,             # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    # published vocab is 256 206; padded to a multiple of 256 (standard
    # deployment practice) so the embedding/logits shard over the
    # 16-way "model" axis — unpadded, the 256 206×1024 embedding plus
    # its f32 optimizer state replicate (8.4 GiB/chip) and the loss
    # chunks blow temp memory (measured; see EXPERIMENTS.md §Perf)
    vocab_size=256256,
    frontend_tokens=4096,    # precomputed speech frames (stub frontend)
    frontend_dim=1024,
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=384,
        frontend_tokens=24,
        frontend_dim=64,
    )
