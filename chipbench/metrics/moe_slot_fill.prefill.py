"""The share of the MoE layers' expert slots that took a token in the
traced sub-window, in percent: the program's ``moe.slots_taken`` over its
``moe.slots``.  The program counts only while a profiler records, and a
run records only in its sub-window.  The registry is the process's, so
the reading is given only where its (token, expert) pairs are exactly the
sub-window's tokens times k times the layers (every layer of the
benchmark's MoE configurations is an MoE layer): a count left by a
profiled call outside the sub-window reads nothing.  At capacity factor
1.25 no more than 80 % of the slots can fill; the rest of that is tokens
dropped or experts left short."""


def read(record):
    tr = record.get("trace")
    if record.get("kind") != "prefill" or not tr:
        return None
    from repro_torch.obs.metrics import METRICS
    counters = METRICS.snapshot()["counters"]
    model = record.get("model") or {}
    pairs = tr.get("tokens", 0) * model.get("experts_per_token", 0) * model.get("n_layers", 0)
    slots = counters.get("moe.slots")
    if not slots or counters.get("moe.pairs_routed") != pairs:
        return None
    return 100.0 * counters.get("moe.slots_taken", 0) / slots
