"""Set-up seconds: process start to the first timed call (imports, the
kernels' build or load, the weights, the warm-up calls or checked
steps), less the check's own readings."""


def read(record):
    return record.get("setup_s")
