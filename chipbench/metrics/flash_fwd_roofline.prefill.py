"""The flash forward kernels' share of their roofline in the traced
sub-window: the least time of every launch (operations over the bf16
peak or bytes over HBM, chipbench/flops.py) over their device time."""
from chipbench.metrics import _device


def read(record):
    return _device.flash_roofline(record, "prefill", forward=True)
