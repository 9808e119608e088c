"""Plain-torch oracles for the kernels — port of ``repro/kernels/ref.py``.

:func:`reference_attention` and :func:`reference_wkv` are also the
Hopper kernels' plain versions (``flash_attention_bhsd_plain``,
``wkv_bhsd_plain``), so the port keeps one plain attention and one plain
WKV, not two of each."""
from __future__ import annotations

import torch

__all__ = ["check_attention_shapes", "check_wkv_shapes",
           "reference_attention", "reference_wkv"]

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


def check_wkv_shapes(r, k, v, w, u, s0) -> None:
    """Raise unless r/k/v/w are ``[B,H,S,hd]``, u ``[H,hd]`` and s0
    ``[B,H,hd,hd]``, with r, k, v of one dtype (w keeps its own)."""
    if r.dim() != 4:
        raise ValueError(f"WKV takes 4-D r/k/v/w [B,H,S,hd]; got r {tuple(r.shape)}")
    b, h, _, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match r {tuple(r.shape)}")
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"u {tuple(u.shape)} is not [H, hd] = {(h, hd)}")
    if tuple(s0.shape) != (b, h, hd, hd):
        raise ValueError(f"s0 {tuple(s0.shape)} is not [B, H, hd, hd] = {(b, h, hd, hd)}")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes of r, k, v differ: {r.dtype}, {k.dtype}, {v.dtype}")


def reference_wkv(r, k, v, w, u, s0):
    """Sequential WKV oracle. r/k/v/w [B,H,S,hd]; u [H,hd]; s0 [B,H,hd,hd].

    Per (b, h) and step t, with the f32 state ``S[key i, value j]``::

        out_t = r_t · (S + (u ⊙ k_t) v_tᵀ)
        S     = diag(w_t) · S + k_t v_tᵀ

    Every input is upcast to f32; returns (out in ``r.dtype``, the final
    state in f32).
    """
    check_wkv_shapes(r, k, v, w, u, s0)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = s0.float()
    outs = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], state + uf * kv))
        state = state * wf[:, :, t, :, None] + kv
    out = torch.stack(outs, dim=2) if outs else rf.new_empty(r.shape)
    return out.to(r.dtype), state
