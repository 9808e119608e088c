"""The benchmark's yardstick: the card's peaks, the flash kernels' work,
and each configuration's model FLOPs a token.

The kernel formulas are a frozen copy of the port's ``kernels/cost.py``
(the algorithm's operations and the bytes it must move, each input read
once and each output written once), so that the yardstick does not move
when the program changes.  The rates are the NVIDIA H100 SXM5 80 GB data
sheet's dense peaks.

Model FLOPs count what the model needs, not what an implementation
dispatches: the projections, the top-k experts of every token (no
capacity slots), the router, the (query, key) pairs the causal mask
keeps, and the unembedding of the positions the path computes (the last
one in prefill, every one in training).  A training step is three times
its forward pass.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "attention_pairs", "attention_flops",
           "attention_bytes", "bwd_flops", "bwd_bytes", "bound_s",
           "forward_flops_per_token", "model_flops_per_token"]

# spec: H100 SXM5, dense, bf16 on the tensor cores and f32 on the CUDA cores
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# spec: HBM3, bytes/s
PEAK_BYTES = 3.35e12


def attention_pairs(s: int, causal: bool, sliding_window: int = 0) -> int:
    """The (query, key) pairs a mask keeps: key k for query q if k <= q when
    causal and k > q - W when ``sliding_window`` W > 0."""
    w = sliding_window if 0 < sliding_window < s else 0
    if causal:
        return w * (w + 1) // 2 + (s - w) * w if w else s * (s + 1) // 2
    return s * s - (s - w) * (s - w + 1) // 2 if w else s * s


def attention_flops(bh: int, s: int, hd: int, causal: bool, sliding_window: int = 0) -> int:
    """Two products (scores, values) over the kept pairs of ``bh`` heads."""
    return 4 * hd * attention_pairs(s, causal, sliding_window) * bh


def attention_bytes(bh: int, bh_kv: int, s: int, hd: int, elem_bytes: int) -> int:
    """q/k/v read once and o written once."""
    return (2 * bh + 2 * bh_kv) * s * hd * elem_bytes


def bwd_flops(bh: int, s: int, hd: int, causal: bool, sliding_window: int = 0) -> int:
    """Five products (scores, dP, dV, dK, dQ) over the kept pairs."""
    return attention_flops(bh, s, hd, causal, sliding_window) * 5 // 2


def bwd_bytes(bh: int, bh_kv: int, s: int, hd: int, elem_bytes: int) -> int:
    """q/k/v/dO and the f32 lse read once, dq/dk/dv written once."""
    return (3 * bh + 4 * bh_kv) * s * hd * elem_bytes + 4 * bh * s


def bound_s(flops: float, nbytes: float, dtype: str = "bf16") -> float:
    """Least time for the work: operations over the peak rate or bytes
    over HBM, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def forward_flops_per_token(m: dict, seq_len: int, unembed_rows: float) -> float:
    """Forward FLOPs a token of a sequence of ``seq_len`` through the decoder
    sized by ``m`` (the keys of a ``configs/*.json`` ``model``), with the
    unembedding computed for ``unembed_rows`` positions a token."""
    d, hq, hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // hq
    proj = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d
    attn = 4 * hd * hq * attention_pairs(seq_len, True, m.get("sliding_window", 0)) / seq_len
    ffn = 3 * 2 * d * m["d_ff"]
    if m.get("n_experts", 0):
        ffn = m["experts_per_token"] * ffn + 2 * d * m["n_experts"]
    return m["n_layers"] * (proj + attn + ffn) + 2 * d * m["vocab_size"] * unembed_rows


def model_flops_per_token(m: dict, seq_len: int, kind: str) -> float:
    """Model FLOPs a token: a prefill unembeds the last position only; a
    training step unembeds every position and costs three forwards."""
    if kind == "prefill":
        return forward_flops_per_token(m, seq_len, 1.0 / seq_len)
    if kind == "train":
        return 3 * forward_flops_per_token(m, seq_len, 1.0)
    raise ValueError(f"no model FLOPs for kind {kind!r}")
