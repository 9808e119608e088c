"""Device milliseconds of cuBLAS's matrix products (projections, expert
products, unembedding) a prefill call, in the traced sub-window."""
from chipbench.metrics import _device


def read(record):
    tr = record.get("trace")
    if record.get("kind") != "prefill" or not tr or not tr.get("calls"):
        return None
    secs, n = _device.kernel_time(
        tr, lambda name: "flash" not in name and any(f in name.lower()
                                                      for f in _device.GEMM_NAMES))
    return 1e3 * secs / tr["calls"] if n else None
