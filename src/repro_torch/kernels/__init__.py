"""Hand-written Hopper kernels of the port, each with its plain-torch
version beside it, and the oracles in :mod:`ref`.

Kernels build at their first launch (:mod:`._build`), never at import."""
from .flash_attention import flash_attention_bhsd, flash_attention_bhsd_plain
from .ops import flash_attention
from .ref import reference_attention

__all__ = ["flash_attention", "flash_attention_bhsd",
           "flash_attention_bhsd_plain", "reference_attention"]
