"""Public kernel entry points in model layout — port of
``repro/kernels/ops.py``."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bhsd
from .rwkv_wkv import wkv_bhsd

__all__ = ["flash_attention", "rwkv_wkv"]


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


def rwkv_wkv(r, k, v, w, u, s0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV recurrence in model layout. r/k/v/w [B,S,H,hd]; u [H,hd];
    s0 [B,H,hd,hd] f32 (None: zeros).  Returns (out [B,S,H,hd], sT)."""
    b, s, h, hd = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    # .contiguous(): the [B,H,S,hd] view of a [B,S,H,hd] tensor is strided
    tr = lambda t: t.transpose(1, 2).contiguous()  # noqa: E731
    out, sT = wkv_bhsd(tr(r), tr(k), tr(v), tr(w), u, s0)
    return out.transpose(1, 2), sT
