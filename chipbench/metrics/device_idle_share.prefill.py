"""The share of the traced sub-window in which no kernel, copy or set ran
on the card, in percent."""
from chipbench.metrics import _device


def read(record):
    return _device.idle_share(record, "prefill")
