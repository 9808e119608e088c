"""Prompt tokens whose last-position logits reached the host in the
window, over the window's seconds."""


def read(record):
    if record.get("kind") != "prefill" or not record.get("window_s"):
        return None
    return record["tokens"] / record["window_s"]
