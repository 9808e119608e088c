"""Hierarchical span tracing with a near-zero disabled fast path.

A :class:`Span` is one timed region — name, start (``perf_counter``),
duration, logical track (``tid``), free-form ``attrs`` — and spans nest
per thread: :meth:`Tracer.span` pushes onto a thread-local stack, so a
``stage.assign`` span opened inside a ``sweep_point`` span records the
parent's depth and the Chrome-trace exporter renders the hierarchy
from the B/E nesting.

The **module-level** entry points are what instrumented code calls:

* :func:`trace_span` — ``with trace_span("stage.merge", k_prime=4):``
  returns a shared no-op context manager when no tracer is active
  (one global load + ``is None`` test: scheduling hot paths pay
  nothing when tracing is off);
* :func:`current_tracer` / :func:`span_attr` — attach attributes
  (e.g. counter deltas) to the innermost open span;
* :func:`activate` — install a tracer for a ``with`` region (the
  scheduler and service loops activate around one run).

Tracing is **provably inert**: spans only read clocks and append to a
list, never feed back into control flow — makespans and service
traces are bit-identical with tracing on or off (asserted by
``tests/test_obs.py``).

Worker processes of the parallel k' sweep install a fresh tracer per
sweep-point task and ship their finished spans back picklably inside
the ``SweepPoint``; the parent splices them into its own tracer, so
one Chrome trace shows worker tracks next to the main process.
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = [
    "Span",
    "Tracer",
    "activate",
    "current_tracer",
    "span_attr",
    "trace_span",
    "tracing_active",
]


@dataclass
class Span:
    """One finished timed region (picklable; ``to_dict`` for JSONL)."""

    name: str
    ts: float                 # perf_counter at entry (seconds)
    dur: float                # seconds
    tid: str                  # logical track, e.g. "main" / "worker-123"
    depth: int = 0            # nesting depth at entry (0 = root)
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "ts": self.ts, "dur": self.dur,
                "tid": self.tid, "depth": self.depth,
                "attrs": dict(self.attrs)}


class _OpenSpan:
    __slots__ = ("name", "t0", "attrs")

    def __init__(self, name: str, t0: float, attrs: dict) -> None:
        self.name = name
        self.t0 = t0
        self.attrs = attrs


class Tracer:
    """Collects spans; one per run (scheduler, service, or user-owned).

    ``probe_spans`` opts into the innermost span level — one span per
    incremental-engine probe (:mod:`repro_torch.core.incremental`).  Off by
    default even when tracing: probes fire tens of thousands of times
    per sweep and the per-span cost would break the ≤10 % enabled
    overhead budget; flip it on for a microscope view of one run.
    """

    def __init__(self, *, probe_spans: bool = False,
                 tid: str | None = None) -> None:
        self.spans: list[Span] = []
        self.probe_spans = probe_spans
        self._default_tid = tid
        self._local = threading.local()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ #
    def _tid(self) -> str:
        if self._default_tid is not None:
            return self._default_tid
        t = threading.current_thread()
        if t is threading.main_thread():
            return f"pid-{os.getpid()}"
        return f"pid-{os.getpid()}/{t.name}"

    def _stack(self) -> list[_OpenSpan]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs):
        stack = self._stack()
        depth = len(stack)
        open_span = _OpenSpan(name, time.perf_counter(), attrs)
        stack.append(open_span)
        try:
            yield open_span
        finally:
            t1 = time.perf_counter()
            stack.pop()
            sp = Span(name=name, ts=open_span.t0,
                      dur=t1 - open_span.t0, tid=self._tid(),
                      depth=depth, attrs=open_span.attrs)
            with self._lock:
                self.spans.append(sp)

    def attr(self, **kv) -> None:
        """Attach attributes to the innermost open span (no-op when no
        span is open)."""
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(kv)

    def extend(self, spans) -> None:
        """Splice finished spans in (worker shipments; already closed,
        their ``tid`` identifies the worker track)."""
        with self._lock:
            self.spans.extend(spans)

    # ------------------------------------------------------------ #
    def by_duration(self, n: int | None = None) -> list[Span]:
        """Spans slowest-first (the ``tools/trace_view.py`` table)."""
        out = sorted(self.spans, key=lambda s: -s.dur)
        return out if n is None else out[:n]


# ------------------------------------------------------------------ #
# the active-tracer slot and the disabled fast path
# ------------------------------------------------------------------ #
_ACTIVE: Tracer | None = None


class _DiscardDict(dict):
    """A write-discarding dict: attribute updates on the null span go
    nowhere (and allocate nothing) when tracing is off."""

    __slots__ = ()

    def __setitem__(self, k, v) -> None:
        pass

    def update(self, *a, **kw) -> None:
        pass


_DISCARD = _DiscardDict()


class _NullSpan:
    """Shared no-op context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    attrs: dict = _DISCARD


_NULL_SPAN = _NullSpan()


def current_tracer() -> Tracer | None:
    """The active tracer, or ``None`` when tracing is off."""
    return _ACTIVE


def tracing_active() -> bool:
    return _ACTIVE is not None


def trace_span(name: str, **attrs):
    """Open a span on the active tracer (shared no-op when inactive)."""
    tr = _ACTIVE
    if tr is None:
        return _NULL_SPAN
    return tr.span(name, **attrs)


def span_attr(**kv) -> None:
    """Attach attributes to the active tracer's innermost open span."""
    tr = _ACTIVE
    if tr is not None:
        tr.attr(**kv)


@contextmanager
def activate(tracer: Tracer | None):
    """Install ``tracer`` as the active tracer for the ``with`` body.

    ``activate(None)`` is a no-op passthrough, so callers can write
    ``with activate(tracer if enabled else None):`` unconditionally —
    an enclosing activation (e.g. the service loop's tracer around a
    scheduler run) stays in effect.  Exit restores the previous
    tracer.
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer if tracer is not None else prev
    try:
        yield tracer
    finally:
        _ACTIVE = prev


@contextmanager
def activate_exclusive(tracer: Tracer | None):
    """Install ``tracer`` *overriding* any enclosing activation —
    ``None`` forcibly disables tracing for the body.  Pool workers use
    this so a fork-inherited parent tracer never collects worker spans
    that could not ship back."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev
