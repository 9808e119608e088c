"""Public kernel entry points in model layout — port of
``repro/kernels/ops.py``."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bhsd
from .rwkv_wkv import wkv_bhsd

__all__ = ["flash_attention", "rwkv_wkv"]


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0) -> torch.Tensor:
    """Flash attention in model layout. q [B,S,H,hd]; k/v [B,S,Hkv,hd];
    ``sliding_window`` > 0 keeps key k for query q only if k > q - W."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    # .contiguous(): at B=1 reshape returns a strided view, not a copy
    qf = q.transpose(1, 2).reshape(b * hq, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, s, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, s, hd).contiguous()
    o = flash_attention_bhsd(qf, kf, vf, causal=causal, sliding_window=sliding_window)
    return o.reshape(b, hq, s, hd).transpose(1, 2)


def rwkv_wkv(r, k, v, w, u, s0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV recurrence in model layout. r/k/v/w [B,S,H,hd]; u [H,hd];
    s0 [B,H,hd,hd] f32 (None: zeros).  Returns (out [B,S,H,hd], sT).

    The kernels read the [B,H,S,hd] views in place and write out in r's
    layout, so no operand is copied and, for a contiguous r, out is a
    contiguous [B,S,H,hd] tensor."""
    b, s, h, hd = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    tr = lambda t: t.transpose(1, 2)  # noqa: E731
    out, sT = wkv_bhsd(tr(r), tr(k), tr(v), tr(w), u, s0)
    return out.transpose(1, 2), sT
