"""Shared arithmetic of the device-trace readers (not a metric)."""
from chipbench import flops

# kernel-name fragments of cuBLAS's matrix products on Hopper
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def idle_share(record, kind):
    tr = record.get("trace")
    if record.get("kind") != kind or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_time(tr, match) -> tuple:
    """(device seconds, launches) of the traced kernels whose name ``match``es."""
    hits = [v for name, v in tr["kernels"].items() if match(name)]
    return sum(v["seconds"] for v in hits), sum(v["launches"] for v in hits)


def flash_roofline(record, kind, forward: bool):
    """The flash kernels' least time over their traced device time, in
    percent: each launch's work by the frozen formulas at the launched
    shape, its mask from the launch counters."""
    tr = record.get("trace")
    if record.get("kind") != kind or not tr:
        return None
    frag = "flash_fwd_" if forward else "flash_bwd_"
    secs, _ = kernel_time(tr, lambda n: frag in n)
    counted = {k: n for k, n in tr.get("launches", {}).items()
               if n and k.startswith("backward") != forward}
    if secs <= 0 or not counted:
        return None
    m = record["model"]
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // hq
    bsz, s = record["batch"], record["seq_len"]
    bound = 0.0
    for key, n in counted.items():
        variant, mask = key.split("/", 1)
        causal = mask.startswith("causal")
        window = m.get("sliding_window", 0) if "+window" in mask else 0
        bf16 = variant in ("wgmma", "backward_wgmma")
        elem, rate = (2, "bf16") if bf16 else (4, "f32")
        if forward:
            ops = flops.attention_flops(bsz * hq, s, hd, causal, window)
            nbytes = flops.attention_bytes(bsz * hq, bsz * hkv, s, hd, elem)
        else:
            ops = flops.bwd_flops(bsz * hq, s, hd, causal, window)
            nbytes = flops.bwd_bytes(bsz * hq, bsz * hkv, s, hd, elem)
        bound += n * flops.bound_s(ops, nbytes, rate)
    return 100.0 * bound / secs
