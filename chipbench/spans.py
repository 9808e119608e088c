"""The program's device spans in a profiler's Chrome trace: device
seconds and idle seconds by span.

While a profiler records, the program opens ``repro_torch.<layer>[.<part>]``
ranges around its layers (``repro_torch.obs.device_span``).  A device
event (kernel, copy, set) is matched to its launch, the runtime event
with the same ``correlation`` id, and goes to the program ranges open at
the launch on the launching thread.  On any thread other than the
window's own (the autograd engine's, which launches the backward), the
main thread's ranges open at that time enclose them: a kernel of the
backward falls under ``repro_torch.train.backward``.  A span's inclusive
time is the union of the intervals of the events under it, its self time
that of the events whose innermost span it is, so work on two streams
is not counted twice.  Idle seconds, the gaps in the union of every
device interval inside the window, go to the innermost program span open
on the main thread at each gap's middle.

:func:`summarize_spans` reads the trace as the profiler exported it:
``trace.read_events`` drops the ``args`` that hold the correlation ids.
"""
from __future__ import annotations

from chipbench.trace import WINDOW, merge

__all__ = ["NO_SPAN", "PROGRAM", "summarize_spans"]

PROGRAM = "repro_torch."
NO_SPAN = "outside the program's spans"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _open_at(ranges, times) -> list:
    """For each of ``times``, the names of the ranges (start, end, name)
    of one thread open at it, outermost first."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out = [()] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(r[2] for r in stack if r[0] <= t <= r[1])
    return out


def _seconds(intervals) -> float:
    return sum(b - a for a, b in merge(intervals)) * 1e-6


def summarize_spans(trace: dict) -> dict:
    """From an exported Chrome trace (a dict) with a ``chipbench.window``
    range: ``busy_s``, the union of device time in the window; ``span_s``,
    by program span its ``inclusive`` and ``self`` device seconds and the
    ``ranges`` of that name opened in the window; ``unattributed_s``, the
    union of the device time under no program span; and
    ``idle_by_span``, idle seconds by the innermost program span open on
    the main thread (``NO_SPAN`` where none was)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} range")
    w0 = float(win[0]["ts"])
    w1, main = w0 + float(win[0]["dur"]), win[0].get("tid")
    device, launch, ranges = [], {}, {}
    for e in events:
        cat, a = e.get("cat", ""), float(e["ts"])
        b = a + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS and b > w0 and a < w1:
            device.append((max(a, w0), min(b, w1), corr))
        elif cat in _LAUNCH_CATS and corr is not None:
            launch[corr] = (e.get("tid"), a)
        elif cat == "user_annotation" and e.get("name", "").startswith(PROGRAM):
            ranges.setdefault(e.get("tid"), []).append((a, b, e["name"]))

    by_thread: dict = {}
    for i, (_, _, corr) in enumerate(device):
        if corr in launch:
            tid, ts = launch[corr]
            by_thread.setdefault(tid, []).append((i, ts))
    paths = [()] * len(device)
    for tid, items in by_thread.items():
        times = [ts for _, ts in items]
        own = _open_at(ranges.get(tid, []), times)
        outer = (_open_at(ranges.get(main, []), times) if tid != main
                 else [()] * len(times))
        for (i, _), o, w in zip(items, outer, own):
            paths[i] = o + w

    under, innermost = {}, {}
    for (a, b, _), path in zip(device, paths):
        for name in set(path):
            under.setdefault(name, []).append((a, b))
        innermost.setdefault(path[-1] if path else None, []).append((a, b))
    opened: dict = {}
    for rs in ranges.values():
        for a, _, name in rs:
            if w0 <= a < w1:
                opened[name] = opened.get(name, 0) + 1
    span_s = {name: {"inclusive": _seconds(iv), "self": _seconds(innermost.get(name, [])),
                     "ranges": opened.get(name, 0)}
              for name, iv in under.items()}

    busy = merge((a, b) for a, b, _ in device)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle: dict = {}
    for (a, b), path in zip(gaps, _open_at(ranges.get(main, []),
                                           [0.5 * (a + b) for a, b in gaps])):
        key = path[-1] if path else NO_SPAN
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    return {"busy_s": _seconds(busy), "span_s": span_s,
            "unattributed_s": _seconds(innermost.get(None, [])), "idle_by_span": idle}
