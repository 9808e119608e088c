"""Exporters: Chrome trace-event JSON (Perfetto-loadable) and JSONL.

Two output shapes, one file format each:

* :func:`write_chrome_trace` — the Trace Event Format consumed by
  ``chrome://tracing`` and https://ui.perfetto.dev.  Wall-clock spans
  become matched ``B``/``E`` duration events (nesting renders the span
  hierarchy), virtual-time service activity becomes ``X`` complete
  events on per-tenant/per-job tracks plus a busy-processor counter
  track, and simulated executions become per-processor ``X`` tracks —
  each group under its own ``pid`` so wall-time and virtual-time
  clock domains never interleave on one track.
* :class:`JsonlSink` — line-oriented JSON event log (one dict per
  line): service narration, span records, anything ``emit()``-ed.

Builders are composable: :func:`span_events`,
:func:`service_virtual_events` and :func:`sim_proc_events` each return
plain event dicts; :func:`write_chrome_trace` sorts and wraps them.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = [
    "JsonlSink",
    "service_virtual_events",
    "sim_proc_events",
    "span_events",
    "write_chrome_trace",
]

_US = 1e6  # seconds -> Chrome trace microseconds


def span_events(spans, *, pid: str = "wall", t0: float | None = None,
                cat: str = "span") -> list[dict]:
    """Matched ``B``/``E`` event pairs from finished :class:`Span`s.

    ``t0`` rebases timestamps (defaults to the earliest span start, so
    the trace begins at 0).  Within one track, ties are broken so that
    ends precede begins (back-to-back siblings), outer spans open
    before inner ones and inner spans close before outer ones —
    Perfetto's stack discipline holds even for zero-duration spans.
    """
    if not spans:
        return []
    if t0 is None:
        t0 = min(s.ts for s in spans)
    raw: list[tuple[float, int, int, dict]] = []
    for s in spans:
        ts = (s.ts - t0) * _US
        te = ts + s.dur * _US
        args = {k: v for k, v in s.attrs.items()}
        raw.append((ts, 1, s.depth, {
            "name": s.name, "ph": "B", "ts": ts, "pid": pid,
            "tid": s.tid, "cat": cat, "args": args,
        }))
        # zero-duration spans must still close after they open: their
        # E ties their own B, so it sorts *after* begins (order 2),
        # while ordinary ends keep preceding same-ts begins (order 0)
        raw.append((te, 0 if s.dur > 0 else 2, -s.depth, {
            "name": s.name, "ph": "E", "ts": te, "pid": pid,
            "tid": s.tid, "cat": cat,
        }))
    raw.sort(key=lambda r: (r[3]["tid"], r[0], r[1], r[2]))
    return [r[3] for r in raw]


def service_virtual_events(trace, *, pid: str = "virtual",
                           unit_s: float = 1.0) -> list[dict]:
    """Virtual-time tracks from a :class:`ServiceTrace`.

    One track per tenant (jobs stack as ``X`` slices: a ``queued``
    slice from arrival to dispatch, a ``run`` slice from dispatch to
    finish), one instant marker per platform event, and a ``busy
    procs`` counter track from the utilization change points.  Virtual
    time maps to trace microseconds at ``unit_s`` seconds per unit.
    """
    scale = unit_s * _US
    ev: list[dict] = []
    for j in trace.jobs:
        if j.status == "rejected":
            continue
        tid = f"tenant:{j.tenant}"
        end = j.finish_t if j.finish_t is not None else trace.horizon
        disp = j.dispatch_t if j.dispatch_t is not None else end
        if disp > j.arrival_t:
            ev.append({
                "name": f"{j.name}#{j.job_id} queued", "ph": "X",
                "ts": j.arrival_t * scale,
                "dur": (disp - j.arrival_t) * scale,
                "pid": pid, "tid": tid, "cat": "job",
                "args": {"status": j.status, "tenant": j.tenant},
            })
        if end > disp or j.status == "completed":
            ev.append({
                "name": f"{j.name}#{j.job_id}", "ph": "X",
                "ts": disp * scale, "dur": (end - disp) * scale,
                "pid": pid, "tid": tid, "cat": "job",
                "args": {
                    "status": j.status,
                    "planning_path": j.planning_path,
                    "k_prime": j.k_prime,
                    "n_replans": j.n_replans,
                    "procs": list(j.allocation),
                },
            })
    for e in trace.events:
        ev.append({
            "name": e.get("kind", "event"), "ph": "i",
            "ts": float(e["time"]) * scale, "pid": pid,
            "tid": "platform", "cat": "event", "s": "p",
            "args": {"detail": e.get("detail", "")},
        })
    for t, busy, k in trace.utilization:
        ev.append({
            "name": "busy procs", "ph": "C", "ts": t * scale,
            "pid": pid, "tid": "platform", "cat": "util",
            "args": {"busy": busy, "total": k},
        })
    return ev


def sim_proc_events(sim, *, pid: str = "sim", unit_s: float = 1.0,
                    t_offset: float = 0.0,
                    stride: int | None = None) -> list[dict]:
    """Per-processor ``X`` tracks from a :class:`repro_torch.sim.SimReport`
    (or anything exposing ``.events`` of ``SimEvent``'s shape).
    ``t_offset`` shifts the segment onto a service/scenario timeline.

    ``stride`` decodes pipelined multi-instance replays
    (:func:`repro_torch.throughput.simulate_pipelined` lowers instance ``i``'s
    block ``v`` to vertex ``i*stride + v``, and its own report exposes
    the stride): slices are named ``i{instance}:b{block}`` and carry
    ``instance`` in their args, so per-instance overlap on one
    processor track is readable — and ``tools/trace_view.py
    --per-instance`` can split tracks per instance.
    """
    scale = unit_s * _US

    def decode(v: int) -> tuple[int | None, int]:
        if stride is None:
            return None, v
        return v // stride, v % stride

    open_at: dict[tuple, float] = {}
    ev: list[dict] = []
    for e in sim.events:
        if e.kind == "task_start":
            open_at[("t", e.vertex)] = e.time
        elif e.kind == "task_finish":
            t0 = open_at.pop(("t", e.vertex), None)
            if t0 is not None:
                inst, base = decode(e.vertex)
                args = {"vertex": base}
                name = f"block {base}"
                if inst is not None:
                    args["instance"] = inst
                    name = f"i{inst}:b{base}"
                ev.append({
                    "name": name, "ph": "X",
                    "ts": (t0 + t_offset) * scale,
                    "dur": (e.time - t0) * scale,
                    "pid": pid, "tid": f"proc:{e.proc}", "cat": "task",
                    "args": args,
                })
        elif e.kind == "transfer_start":
            open_at[("x", e.edge)] = e.time
        elif e.kind == "transfer_finish":
            t0 = open_at.pop(("x", e.edge), None)
            if t0 is not None:
                inst, src = decode(e.edge[0])
                _, dst = decode(e.edge[1])
                args = {"edge": [src, dst]}
                name = f"xfer {src}→{dst}"
                if inst is not None:
                    args["instance"] = inst
                    name = f"i{inst}:xfer {src}→{dst}"
                ev.append({
                    "name": name, "ph": "X",
                    "ts": (t0 + t_offset) * scale,
                    "dur": (e.time - t0) * scale,
                    "pid": pid, "tid": "transfers", "cat": "transfer",
                    "args": args,
                })
    return ev


def write_chrome_trace(path, events, *, meta: dict | None = None) -> Path:
    """Sort ``events`` by timestamp and write the Trace Event JSON.

    The global sort keeps ``ts`` monotone across the whole file (the
    schema property ``tools/trace_view.py`` and the tests check);
    per-track B/E ordering from :func:`span_events` is preserved for
    equal timestamps because ``sort`` is stable.
    """
    path = Path(path)
    doc = {
        "traceEvents": sorted(events, key=lambda e: e["ts"]),
        "displayTimeUnit": "ms",
    }
    if meta:
        doc["otherData"] = meta
    path.write_text(json.dumps(doc))
    return path


class JsonlSink:
    """Append-mode line-oriented JSON event log.

    ``emit(dict)`` writes one compact JSON line immediately (narration
    streams out even if the run dies); ``close()`` flushes.  Usable as
    a context manager.  A ``None`` path builds a disabled sink whose
    ``emit`` is a no-op — call sites never need to branch.
    """

    def __init__(self, path=None) -> None:
        self.path = Path(path) if path is not None else None
        self._fh = self.path.open("a") if self.path is not None else None

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def emit(self, record: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(record, separators=(",", ":"))
                           + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
