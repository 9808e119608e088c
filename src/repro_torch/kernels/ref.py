"""Plain-torch oracle for the attention kernel — port of
``repro/kernels/ref.py::reference_attention``.  It is also the Hopper
kernel's plain version (``flash_attention_bhsd_plain``), so the port
keeps one plain attention, not two.  The WKV oracle arrives with the
RWKV slice."""
from __future__ import annotations

import torch

__all__ = ["check_attention_shapes", "reference_attention"]

_NEG_INF = -1e30


def check_attention_shapes(q, k, v) -> None:
    """Raise unless q is ``[BHq,S,hd]``, k/v ``[BHkv,S,hd]`` with BHkv | BHq,
    all of one dtype."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention takes 3-D q [BHq,S,hd], k/v [BHkv,S,hd]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, hd = q.shape
    bh_kv = k.shape[0]
    if k.shape != v.shape or k.shape[1:] != (s, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if bh_kv == 0 or bh % bh_kv:
        raise ValueError(f"q heads {bh} not a multiple of kv heads {bh_kv}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def reference_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Naive softmax attention. q [BH,S,hd]; k/v [BHkv,S,hd].

    The kernel's arithmetic: q, k, v upcast to f32, q scaled in f32, the
    full score matrix in f32, output cast to ``q.dtype``.  Query head
    ``b`` reads kv head ``b // group`` without repeating K/V.
    """
    check_attention_shapes(q, k, v)
    bh, s, hd = q.shape
    bh_kv = k.shape[0]
    qg = (q.float() * (hd ** -0.5)).reshape(bh_kv, bh // bh_kv, s, hd)
    scores = qg @ k.float()[:, None].transpose(-1, -2)    # [BHkv, G, S, S]
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return (p @ v.float()[:, None]).reshape(bh, s, hd).to(q.dtype)
