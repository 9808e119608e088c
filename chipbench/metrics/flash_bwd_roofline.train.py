"""The flash backward kernels' share of their roofline in the traced
sub-window: each backward launch's least time (its five products over
the bf16 peak or its bytes over HBM, chipbench/flops.py) over the device
time of its dQ and dK/dV kernels."""
from chipbench.metrics import _device


def read(record):
    return _device.flash_roofline(record, "train", forward=False)
