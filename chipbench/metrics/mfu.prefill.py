"""Model FLOPs of the traced run's window over its seconds and the card's
bf16 peak, in percent (chipbench/flops.py)."""
from chipbench import flops


def read(record):
    if record.get("kind") != "prefill" or not record.get("window_s"):
        return None
    per_token = flops.model_flops_per_token(record["model"], record["seq_len"], "prefill")
    return 100.0 * per_token * record["tokens"] / record["window_s"] / flops.PEAK_FLOPS["bf16"]
