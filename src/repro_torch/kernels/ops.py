"""Public kernel entry points in model layout — port of
``repro/kernels/ops.py``.  The WKV entry arrives with the RWKV slice."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bhsd

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Flash attention in model layout. q [B,S,H,hd]; k/v [B,S,Hkv,hd]."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    # .contiguous(): at B=1 reshape returns a strided view, not a copy
    qf = q.transpose(1, 2).reshape(b * hq, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, s, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, s, hd).contiguous()
    o = flash_attention_bhsd(qf, kf, vf, causal=causal)
    return o.reshape(b, hq, s, hd).transpose(1, 2)
