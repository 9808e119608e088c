"""Milliseconds a step from step_fn's "adamw" mark to its "end" mark
(CUDA events), the mean over the traced steps."""


def read(record):
    tr = record.get("trace")
    ms = tr.get("adamw_ms") if record.get("kind") == "train" and tr else None
    return sum(ms) / len(ms) if ms else None
