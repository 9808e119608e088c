"""The discrete-event core: replay a block schedule on a platform.

:func:`run_engine` executes a set of :class:`BlockSpec` compute units
(quotient vertices pinned to processors) connected by :class:`EdgeSpec`
transfers, under a pluggable communication model
(:mod:`repro_torch.sim.comm`).  The event loop interleaves three streams —
block-finish events (a heap owned by the engine), release events (for
blocks whose earliest start is gated on an external instant, e.g. a
workflow instance's arrival in pipelined replays) and transfer
completions (owned by the comm model) — processing them in global time
order with deterministic tie-breaking (block finishes first, then
releases, then transfers by edge key).

Semantics (the paper's execution model, §3.3):

* a block occupies its processor for ``duration`` time units, starting
  once **all** incoming transfers have completed, its release time (if
  any) has passed and the processor is free (blocks sharing a
  processor serialize in ready-time order — a no-op for the paper's
  injective mappings, but exactly the interference model pipelined
  multi-instance replays need);
* every outgoing quotient edge starts transferring the moment its
  source block finishes; the comm model decides when it lands.

``run_engine(..., release={vid: t})`` floors each listed block's start
at ``t``: :mod:`repro_torch.throughput` lowers N instances of one workflow
into disjoint vid ranges whose sources are released at the instance
arrival times, so instance i+1's sources overlap instance i's sinks on
the shared processors.  An empty/absent ``release`` map reproduces the
original behavior bit-exactly (every floor is 0.0 and the release heap
never populates — the identity anchor below is unaffected).

Pause / resume
--------------
``run_engine(..., stop_time=t)`` pauses the replay *before* processing
the first event strictly later than ``t``: every block finish and
transfer completion at or before ``t`` is applied, then the engine
state is frozen into an :class:`EngineCheckpoint` attached to the
returned (partial) trace.  :func:`resume_engine` continues a checkpoint
— possibly pausing again — and an uninterrupted run and any
pause/resume chain produce **bit-identical** traces (the event order
never depends on where the pause falls).  This is what
:mod:`repro_torch.scenario` builds on: pause at a platform event, freeze the
completed/in-flight prefix, replan the residual.  A checkpoint holds
the live engine structures (including the comm model) by reference, so
it is single-use: resuming mutates it in place.

Bit-exactness anchor (CPM duality)
----------------------------------
The analytic makespan (Eq. (2)) folds bottom weights from the sinks::

    l_v = w_v/s_v + max_child(c/beta + l_child)

A forward ASAP replay folds the *same* terms from the sources, so in
float64 it agrees only to round-off (addition is not associative).
Running this very engine on the **transposed** DAG — the classic
critical-path-method backward pass — computes each block's finish time
as ``fl(max_child(fl(l_child + c/beta)) + w_v/s_v)``: the identical
operand pairs as the recursion above, merely swapped within each
addition, and IEEE-754 addition *is* commutative.  Hence the backward
pass's horizon equals ``repro_torch.core.makespan.makespan`` **bit-exactly**
under contention-free deterministic settings — a strong end-to-end
check that the event loop implements the paper's model, not an
approximation of it.  :func:`repro_torch.sim.simulate` runs the forward pass
for the trace and the backward pass for the canonical makespan.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from repro_torch.obs.tracer import trace_span

from .report import SimEvent

__all__ = ["BlockSpec", "EdgeSpec", "EngineCheckpoint", "EngineTrace",
           "resume_engine", "run_engine", "transpose_edges"]


@dataclass(frozen=True)
class BlockSpec:
    """One schedulable compute unit (a quotient block on a processor)."""

    vid: int
    proc: int
    duration: float


@dataclass(frozen=True)
class EdgeSpec:
    """One aggregated inter-block transfer of ``volume`` units."""

    src: int
    dst: int
    volume: float


@dataclass
class EngineTrace:
    """Raw engine output; :func:`repro_torch.sim.simulate` dresses it up.

    ``checkpoint`` is set iff the run paused at a ``stop_time`` with
    work still outstanding; the trace then covers the executed prefix
    only (``finish`` holds the completed blocks, ``start`` additionally
    the in-flight ones).
    """

    start: dict[int, float]
    finish: dict[int, float]
    xfer_start: dict[tuple[int, int], float]
    xfer_finish: dict[tuple[int, int], float]
    events: list[SimEvent] = field(default_factory=list)
    horizon: float = 0.0
    checkpoint: "EngineCheckpoint | None" = None

    @property
    def paused(self) -> bool:
        return self.checkpoint is not None

    def in_flight(self) -> set[int]:
        """Blocks started but not finished (empty for completed runs)."""
        return set(self.start) - set(self.finish)


@dataclass
class EngineCheckpoint:
    """Frozen mid-replay engine state (see module docstring).

    Opaque to callers: pass it to :func:`resume_engine`.  Holds live
    references (including the comm model), so it is single-use.
    """

    time: float
    by_vid: dict
    out_edges: dict
    pending: dict
    arrival: dict
    proc_busy: dict
    proc_free_at: dict
    proc_queue: dict
    finish_heap: list
    comm: object
    record_events: bool
    trace: EngineTrace
    # (t, vid) heap of future release instants (empty unless the run
    # was given explicit release times)
    release_heap: list = field(default_factory=list)


def transpose_edges(edges: list[EdgeSpec]) -> list[EdgeSpec]:
    """The reversed-DAG edge set (for the CPM backward pass)."""
    return [EdgeSpec(e.dst, e.src, e.volume) for e in edges]


def _drive(cp: EngineCheckpoint, stop_time: float | None,
           initial_ready: list[int]) -> EngineTrace:
    """The event loop, runnable from a fresh state or a checkpoint."""
    by_vid = cp.by_vid
    out_edges = cp.out_edges
    pending = cp.pending
    arrival = cp.arrival
    proc_busy = cp.proc_busy
    proc_free_at = cp.proc_free_at
    proc_queue = cp.proc_queue
    finish_heap = cp.finish_heap
    release_heap = cp.release_heap
    comm = cp.comm
    record_events = cp.record_events
    trace = cp.trace
    events = trace.events

    def start_block(v: int, t: float) -> None:
        b = by_vid[v]
        trace.start[v] = t
        proc_busy[b.proc] = True
        heapq.heappush(finish_heap, (t + b.duration, v))
        if record_events:
            events.append(SimEvent(time=t, kind="task_start",
                                   vertex=v, proc=b.proc))

    def on_ready(v: int, t: float) -> None:
        p = by_vid[v].proc
        if proc_busy.get(p, False):
            heapq.heappush(proc_queue.setdefault(p, []), (t, v))
        else:
            # an idle processor was freed no later than now, so
            # ``max(t, free_at)`` is ``t`` except for ready-at-0 ties
            start_block(v, max(t, proc_free_at.get(p, 0.0)))

    for v in initial_ready:
        on_ready(v, arrival[v])

    while finish_heap or release_heap or comm.has_active():
        nxt = comm.next_completion()
        # ties: block finishes strictly before releases, which precede
        # transfer completions — a finishing block's own outgoing
        # transfers join the comm state before same-instant completions
        # are popped, and a processor freed at t serves a block
        # released at t before later-arriving work
        kind = 0  # 0 = block finish, 1 = release, 2 = transfer
        t_next = finish_heap[0][0] if finish_heap else None
        if release_heap and (t_next is None
                             or release_heap[0][0] < t_next):
            t_next, kind = release_heap[0][0], 1
        if nxt is not None and (t_next is None or nxt[0] < t_next):
            t_next, kind = nxt[0], 2
        take_block = kind == 0
        if stop_time is not None and t_next > stop_time:
            # pause *before* the first event past the stop time: the
            # executed prefix is exactly the uninterrupted run's events
            # with time <= stop_time
            cp.time = stop_time
            trace.checkpoint = cp
            trace.horizon = max(trace.finish.values(), default=0.0)
            return trace
        if take_block:
            t, v = heapq.heappop(finish_heap)
            b = by_vid[v]
            trace.finish[v] = t
            proc_busy[b.proc] = False
            proc_free_at[b.proc] = t
            if record_events:
                events.append(SimEvent(time=t, kind="task_finish",
                                       vertex=v, proc=b.proc))
            for e in out_edges[v]:
                key = (e.src, e.dst)
                comm.start(t, key, e.volume, b.proc, by_vid[e.dst].proc)
                trace.xfer_start[key] = t
                if record_events:
                    events.append(SimEvent(time=t, kind="transfer_start",
                                           edge=key, proc=b.proc))
            q = proc_queue.get(b.proc)
            if q:
                _, w = heapq.heappop(q)
                start_block(w, t)
        elif kind == 1:
            t, v = heapq.heappop(release_heap)
            on_ready(v, t)
        else:
            t, key = comm.complete()
            trace.xfer_finish[key] = t
            dst = key[1]
            if record_events:
                events.append(SimEvent(time=t, kind="transfer_finish",
                                       edge=key, proc=by_vid[dst].proc))
            if t > arrival[dst]:
                arrival[dst] = t
            pending[dst] -= 1
            if pending[dst] == 0:
                if arrival[dst] > t:
                    # release floor still ahead of the last transfer:
                    # defer readiness to the release instant so an
                    # idle processor is not held for a future block
                    heapq.heappush(release_heap, (arrival[dst], dst))
                else:
                    on_ready(dst, arrival[dst])

    if len(trace.finish) != len(by_vid):
        raise ValueError(
            f"{len(by_vid) - len(trace.finish)} blocks never became "
            "ready — the block graph is cyclic"
        )
    trace.checkpoint = None
    trace.horizon = max(trace.finish.values(), default=0.0)
    return trace


def run_engine(blocks: list[BlockSpec], edges: list[EdgeSpec], comm,
               platform, *, record_events: bool = True,
               stop_time: float | None = None,
               release: dict[int, float] | None = None) -> EngineTrace:
    """Replay ``blocks``/``edges`` under ``comm``; see module docstring.

    ``stop_time`` pauses the replay after the last event at or before
    that time; the returned trace then carries a resumable
    :class:`EngineCheckpoint` (``trace.checkpoint``) unless the replay
    already completed.  ``release`` floors listed blocks' start times
    (instance arrivals in pipelined replays; absent blocks are released
    at 0, and an all-zero map is bit-identical to no map).  Raises
    ``ValueError`` when the block graph is cyclic (some block can never
    start) or a release time is negative.
    """
    # one span per replay (wall-clock cost of the virtual-time engine)
    with trace_span("sim.run_engine", n_blocks=len(blocks),
                    n_edges=len(edges)):
        return _run_engine(blocks, edges, comm, platform,
                           record_events=record_events,
                           stop_time=stop_time, release=release)


def _run_engine(blocks: list[BlockSpec], edges: list[EdgeSpec], comm,
                platform, *, record_events: bool = True,
                stop_time: float | None = None,
                release: dict[int, float] | None = None) -> EngineTrace:
    by_vid = {b.vid: b for b in blocks}
    if len(by_vid) != len(blocks):
        raise ValueError("duplicate block vid")
    rel = release or {}
    if any(t < 0 for t in rel.values()):
        raise ValueError("release times must be >= 0")
    out_edges: dict[int, list[EdgeSpec]] = {v: [] for v in by_vid}
    pending: dict[int, int] = {v: 0 for v in by_vid}
    seen_edges: set[tuple[int, int]] = set()
    for e in edges:
        # (src, dst) keys transfers throughout (quotient edges are
        # aggregated); duplicates would alias in the comm models
        if (e.src, e.dst) in seen_edges:
            raise ValueError(f"duplicate edge {(e.src, e.dst)}")
        seen_edges.add((e.src, e.dst))
        out_edges[e.src].append(e)
        pending[e.dst] += 1
    for v in out_edges:
        out_edges[v].sort(key=lambda e: e.dst)

    comm.reset(platform)
    trace = EngineTrace(start={}, finish={}, xfer_start={}, xfer_finish={})
    cp = EngineCheckpoint(
        time=0.0, by_vid=by_vid, out_edges=out_edges, pending=pending,
        # release times double as the arrival floor: a block is never
        # ready before max(its release, its last incoming transfer)
        arrival={v: rel.get(v, 0.0) for v in by_vid},
        # per-processor serialization state (trivial for injective maps)
        proc_busy={}, proc_free_at={}, proc_queue={}, finish_heap=[],
        comm=comm, record_events=record_events, trace=trace,
    )
    # zero-pred blocks released in the future wait on the release heap
    # (starting them eagerly would hold their processor busy from t=0);
    # the rest are ready now, exactly as before
    ready = []
    for v in sorted(by_vid):
        if pending[v] != 0:
            continue
        if cp.arrival[v] > 0.0:
            heapq.heappush(cp.release_heap, (cp.arrival[v], v))
        else:
            ready.append(v)
    return _drive(cp, stop_time, ready)


def resume_engine(checkpoint: EngineCheckpoint, *,
                  stop_time: float | None = None) -> EngineTrace:
    """Continue a paused replay from ``checkpoint``.

    ``stop_time`` (which must be ≥ the checkpoint's pause time) pauses
    again; otherwise the replay runs to completion.  The returned trace
    is the same object the pausing run returned, extended in place —
    resuming to completion yields a trace bit-identical to an
    uninterrupted run.
    """
    if stop_time is not None and stop_time < checkpoint.time:
        raise ValueError(
            f"stop_time {stop_time} precedes checkpoint time "
            f"{checkpoint.time}"
        )
    checkpoint.trace.checkpoint = None
    return _drive(checkpoint, stop_time, [])
