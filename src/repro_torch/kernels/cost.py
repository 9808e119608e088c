"""The work of the port's kernels, and the card's rates it is held to.

One copy of the formulas that set ``PERF.md``'s bound column
(``chip_smoke.py`` imports them) and of the work the kernels' meta
branches record for the dry run (:mod:`repro_torch.launch.op_analysis`):
for each kernel, the algorithm's operations and the bytes it must move,
each input read once and each output written once.

The rates are the NVIDIA H100 SXM5 80 GB data sheet's, dense: they are
*spec* values, not measurements.

While a dry run's analysis is active it adds a sink with
:func:`add_sink`; :func:`record` hands each meta launch to every sink.
Nothing here touches a card.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "HBM_BYTES", "LINK_BYTES",
           "attention_flops", "attention_bytes", "attention_bound_ms",
           "bwd_flops", "bwd_bytes", "bwd_bound_ms",
           "wkv_flops", "wkv_bytes", "wkv_bound_ms",
           "wkv_bwd_flops", "wkv_bwd_bytes", "wkv_bwd_bound",
           "add_sink", "remove_sink", "record"]

# spec: H100 SXM5 dense peak, bf16 on the tensor cores and f32 on the CUDA
# cores (no TF32), FLOP/s
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# spec: HBM3 bandwidth, bytes/s
PEAK_BYTES = 3.35e12
# spec: 80 GB of HBM3 (five stacks of 16 GiB)
HBM_BYTES = 80 * 2**30
# spec: one GPU's share of the inter-node network, NDR InfiniBand at 400
# Gb/s; every 16-rank axis of the production meshes spans two 8-GPU nodes
LINK_BYTES = 50e9


def _bound(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------------- #
# flash attention (kernels/flash_attention.py)
# ---------------------------------------------------------------------- #
def attention_flops(bh, s, hd, causal) -> int:
    """The algorithm's operations: two products over the unmasked score pairs."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * hd * pairs * bh


def attention_bytes(bh, bh_kv, s, hd, elem_bytes) -> int:
    """q/k/v read once and o written once."""
    return (2 * bh + 2 * bh_kv) * s * hd * elem_bytes


def attention_bound_ms(bh, bh_kv, s, hd, causal, dtype, elem_bytes) -> tuple[float, str]:
    """Least time for the work: the unmasked score pairs' two products over
    the peak rate, or q/k/v read once and o written once over HBM."""
    return _bound(attention_flops(bh, s, hd, causal),
                  attention_bytes(bh, bh_kv, s, hd, elem_bytes), dtype)


def bwd_flops(bh, s, hd, causal) -> int:
    """The backward's operations: five products (scores, dP, dV, dK, dQ)
    over the unmasked score pairs, 2.5x the forward's two."""
    return attention_flops(bh, s, hd, causal) * 5 // 2


def bwd_bytes(bh, bh_kv, s, hd, elem_bytes) -> int:
    """q/k/v/dO and the f32 lse read once, dq/dk/dv written once."""
    return (3 * bh + 4 * bh_kv) * s * hd * elem_bytes + 4 * bh * s


def bwd_bound_ms(bh, bh_kv, s, hd, causal, dtype, elem_bytes) -> tuple[float, str]:
    """Least time for the backward's work: its operations over the peak
    rate of the input type, or :func:`bwd_bytes` over HBM."""
    return _bound(bwd_flops(bh, s, hd, causal), bwd_bytes(bh, bh_kv, s, hd, elem_bytes), dtype)


# ---------------------------------------------------------------------- #
# WKV (kernels/rwkv_wkv.py): f32 arithmetic on the CUDA cores
# ---------------------------------------------------------------------- #
def wkv_flops(b, h, s, hd) -> int:
    """5 hd^2 f32 operations per (b, h, t): r.S is hd^2 FMAs, the update
    one multiply and one FMA per element."""
    return 5 * hd * hd * b * h * s


def wkv_bytes(b, h, s, hd, io_bytes, w_bytes) -> int:
    """r/k/v/w/u/s0 read once and out/sT written once."""
    return (b * h * s * hd * (4 * io_bytes + w_bytes) + h * hd * io_bytes
            + 2 * b * h * hd * hd * 4)


def wkv_bound_ms(b, h, s, hd, io_bytes, w_bytes) -> tuple[float, str]:
    """Least time for the work: :func:`wkv_flops` on the CUDA cores, or
    :func:`wkv_bytes` over HBM."""
    return _bound(wkv_flops(b, h, s, hd), wkv_bytes(b, h, s, hd, io_bytes, w_bytes), "f32")


def wkv_bwd_flops(b, h, s, hd) -> int:
    """12 hd^2 f32 operations per (b, h, t): the S and G recurrences (an
    FMA per entry each) and four hd-long dots a row (dr, dk, dv, dw)."""
    return 12 * hd * hd * b * h * s


def wkv_bwd_bytes(b, h, s, hd, io_bytes, w_bytes) -> int:
    """r/k/v/dout and w read once, dr/dk/dv and dw written once, plus u,
    s0, du and ds0."""
    return (b * h * s * hd * (7 * io_bytes + 2 * w_bytes) + 2 * h * hd * 4
            + 2 * b * h * hd * hd * 4)


def wkv_bwd_bound(b, h, s, hd, io_bytes, w_bytes) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, operations, bytes) of the WKV gradient."""
    ops, nbytes = wkv_bwd_flops(b, h, s, hd), wkv_bwd_bytes(b, h, s, hd, io_bytes, w_bytes)
    return (*_bound(ops, nbytes, "f32"), ops, nbytes)


# ---------------------------------------------------------------------- #
# the meta launches' sinks
# ---------------------------------------------------------------------- #
_SINKS: list = []


def add_sink(sink) -> None:
    """``sink(kernel, flops, nbytes, dtype)`` is called for every meta
    launch until :func:`remove_sink`."""
    _SINKS.append(sink)


def remove_sink(sink) -> None:
    _SINKS.remove(sink)


def record(kernel: str, flops: float, nbytes: float, dtype: str) -> None:
    """A kernel's launch on meta tensors: its work, to every sink.
    ``dtype`` names the peak rate the work runs at ("bf16" or "f32")."""
    for sink in list(_SINKS):
        sink(kernel, flops, nbytes, dtype)
