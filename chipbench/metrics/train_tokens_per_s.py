"""Trained tokens of every step in the window, over the window's seconds."""


def read(record):
    if record.get("kind") != "train" or not record.get("window_s"):
        return None
    return record["tokens"] / record["window_s"]
