"""A traced sub-window: ``torch.profiler`` over a few steady calls, read
back from its Chrome trace into what the per-layer metrics need.

The device's busy time is the union of its kernel, copy and set
intervals inside the window; the window is the ``chipbench.window``
range on the same clock.  Each idle gap is named by what the host was
doing at its middle: the benchmark's own range there and the innermost
host event under it.  The arithmetic of the device's busy share and top
kernels follows ``chip_smoke.py``'s ``profile_window``; here it reads
intervals, not sums, so that work on two streams is not counted twice.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

__all__ = ["SubWindow", "Tracer", "merge", "read_events", "summarize"]

WINDOW = "chipbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


class Tracer:
    """Start and stop the profiler around a sub-window; read it after."""

    def __init__(self) -> None:
        self._prof = None
        self._range = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, in set-up: its first start
        loads and sets up the device tracer."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def read(self) -> list:
        """The trace's complete events (written to a temporary file, read
        and removed)."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="chipbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = read_events(json.load(f))
        finally:
            os.remove(path)
        self._prof = None
        return events


class SubWindow:
    """A run's traced sub-window: it opens at the first call that starts
    a third into the window and closes after the first call that ends
    ``min(4 s, seconds / 3)`` later.  ``launches()`` gives the kernels'
    launch counts so far; the record holds their change over the
    sub-window, its calls and tokens, and the trace's summary."""

    def __init__(self, t0: float, seconds: float, launches) -> None:
        self.tracer = Tracer()
        self.opens_at = t0 + seconds / 3
        self.length = min(4.0, seconds / 3)
        self.launches = launches
        self.state = "before"
        self.counts = {"calls": 0, "tokens": 0}

    def open_if_due(self, now: float) -> bool:
        """Whether the call submitted at ``now`` is traced."""
        if self.state == "before" and now >= self.opens_at:
            self._before = self.launches()
            self.tracer.start()
            self.closes_at = time.perf_counter() + self.length
            self.state = "open"
        return self.state == "open"

    def count(self, done: float, tokens: int) -> None:
        """A traced call ended at ``done`` with ``tokens`` tokens."""
        if self.state == "open":
            self.counts["calls"] += 1
            self.counts["tokens"] += tokens
            if done >= self.closes_at:
                self.close()

    def close(self) -> None:
        if self.state == "open":
            self.tracer.stop()
            after = self.launches()
            self.counts["launches"] = {k: n - self._before.get(k, 0) for k, n in after.items()}
            self.state = "closed"

    def record(self) -> dict | None:
        """The sub-window's record (None: it never opened)."""
        if self.state == "before":
            return None
        self.close()
        return {**summarize(self.tracer.read()), **self.counts}


def read_events(trace: dict) -> list:
    """The complete ("X") events of a Chrome trace as (cat, name, start
    us, end us, tid) tuples."""
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts = float(e["ts"])
        out.append((e.get("cat", ""), e.get("name", ""), ts, ts + float(e["dur"]),
                    e.get("tid")))
    return out


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gap_names(gaps, host) -> list:
    """For each gap (sorted), ``"<benchmark range> > <innermost host
    event>"`` at its middle, from host events (start, end, name) of one
    thread."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    names, stack, j = [], [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        live = [e for e in stack if e[0] <= mid <= e[1]]
        ours = [e[2] for e in live if e[2].startswith("chipbench.") and e[2] != WINDOW]
        inner = live[-1][2] if live else "nothing"
        outer = ours[-1] if ours else "outside the benchmark's ranges"
        names.append(outer if inner == outer else f"{outer} > {inner}")
    return names


def summarize(events, top: int = 10) -> dict:
    """What the per-layer readers take from a trace: the window's seconds,
    the device's busy seconds in it, device seconds and launches by
    kernel name, and the top device operations and idle gaps (by host
    activity), seconds each."""
    win = [e for e in events if e[1] == WINDOW and e[0] == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} range")
    w0, w1, main_tid = win[0][2], win[0][3], win[0][4]
    device = [e for e in events if e[0] in _DEVICE_CATS and e[3] > w0 and e[2] < w1]
    busy = merge((max(e[2], w0), min(e[3], w1)) for e in device)
    kernels: dict = {}
    for cat, name, a, b, _ in device:
        secs, n = kernels.get(name, (0.0, 0))
        kernels[name] = (secs + (min(b, w1) - max(a, w0)) * 1e-6, n + 1)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    gaps = [g for g in gaps if g[1] > g[0]]
    host = [(a, b, name) for cat, name, a, b, tid in events
            if cat in _HOST_CATS and tid == main_tid and b > w0 and a < w1]
    idle: dict = {}
    for (a, b), name in zip(gaps, _gap_names(gaps, host)):
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": {name: {"seconds": s, "launches": n} for name, (s, n) in kernels.items()},
        "device_ops": [[name[:160], s] for name, s in rank({k: v[0] for k, v in kernels.items()})],
        "idle_gaps": [[name[:160], s] for name, s in rank(idle)],
    }
