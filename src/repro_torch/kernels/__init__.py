"""Hand-written Hopper kernels of the port, each with its plain-torch
version beside it, and the oracles in :mod:`ref`.

Kernels build at their first launch (:mod:`._build`), never at import."""
from .flash_attention import flash_attention_bhsd, flash_attention_bhsd_plain
from .ops import flash_attention, rwkv_wkv
from .ref import reference_attention, reference_wkv
from .rwkv_wkv import wkv_bhsd, wkv_bhsd_plain

__all__ = ["flash_attention", "flash_attention_bhsd",
           "flash_attention_bhsd_plain", "reference_attention",
           "reference_wkv", "rwkv_wkv", "wkv_bhsd", "wkv_bhsd_plain"]
