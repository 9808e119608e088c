"""Input pipeline of the port — its own copy of ``repro/data``."""
from .pipeline import DataConfig, Prefetcher, SyntheticTokens, host_slice

__all__ = ["DataConfig", "Prefetcher", "SyntheticTokens", "host_slice"]
