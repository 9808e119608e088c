"""repro_torch.sim — discrete-event execution of mapped workflows.

The optimizer (:mod:`repro_torch.core`) *prices* a mapping with the analytic
bottom-weight formula; this subsystem *executes* one: an event-driven
replay of the quotient schedule on the platform, producing
per-processor timelines, a transfer log, a time-resolved memory
occupancy trace, and robustness envelopes under stochastic durations —
ground truth for everything the analytic proxy abstracts away.

Entry point::

    from repro_torch.sim import simulate
    rep = simulate(schedule(wf, plat).best)        # paper model
    rep.makespan           # == repro_torch.core.makespan() bit-exactly
    rep = simulate(res, comm="fair-share")         # link contention
    rep = simulate(res, jitter=0.2, replicas=32)   # robustness envelope
    print(rep.gantt())

or as a scheduler pipeline stage: ``schedule(wf, plat, simulate=True)``
attaches a :class:`SimReport` to every sweep point's mapping
(``report.sim`` / ``result.extras["sim"]``).

Modules: :mod:`~repro_torch.sim.engine` (event loop + the CPM backward pass
that anchors bit-exactness), :mod:`~repro_torch.sim.comm` (communication
models), :mod:`~repro_torch.sim.memory` (occupancy tracker),
:mod:`~repro_torch.sim.perturb` (seeded jitter), :mod:`~repro_torch.sim.report`
(:class:`SimReport`).

Adding a communication model
----------------------------
Implement the small protocol documented in :mod:`repro_torch.sim.comm`
(``reset`` / ``start`` / ``has_active`` / ``next_completion`` /
``complete``) and pass an instance as ``simulate(..., comm=model)`` —
the engine never special-cases models, it only orders completions.
Only :class:`~repro_torch.sim.comm.ContentionFreeComm` claims the bit-exact
analytic anchor; any other model is measured *against* it.
"""
from __future__ import annotations

from repro_torch.core.makespan import makespan as _analytic_makespan
from repro_torch.core.platform import Platform

from .comm import ContentionFreeComm, FairShareComm, resolve_comm
from .engine import (
    BlockSpec,
    EdgeSpec,
    EngineCheckpoint,
    resume_engine,
    run_engine,
    transpose_edges,
)
from .memory import build_memory_trace, pick_block_order
from .perturb import JitterSpec
from .rng import stream_rng
from .report import (
    JitterEnvelope,
    MemoryTrace,
    MemoryViolation,
    ProcUtilization,
    SimEvent,
    SimReport,
    TransferRecord,
)

__all__ = [
    "BlockSpec",
    "EdgeSpec",
    "EngineCheckpoint",
    "ContentionFreeComm",
    "FairShareComm",
    "JitterEnvelope",
    "JitterSpec",
    "MemoryTrace",
    "MemoryViolation",
    "ProcUtilization",
    "SimEvent",
    "SimReport",
    "TransferRecord",
    "build_memory_trace",
    "build_specs",
    "resolve_comm",
    "resume_engine",
    "run_engine",
    "simulate",
    "stream_rng",
    "trace_memory",
]


class _ReversedLinkView:
    """Platform facade for the CPM backward pass: the engine runs on
    the transposed DAG, so link lookups must swap back to price the
    original direction (matters only for asymmetric overrides)."""

    def __init__(self, platform: Platform) -> None:
        self._platform = platform
        self.bandwidth = platform.bandwidth

    def bandwidth_between(self, i: int, j: int) -> float:
        return self._platform.bandwidth_between(j, i)


def build_specs(q, platform: Platform):
    """Deterministic (blocks, edges) for a fully assigned quotient.

    The lowering :func:`simulate` uses internally, public so callers
    (e.g. :mod:`repro_torch.scenario`) can run the engine directly — with a
    ``stop_time`` pause — on the exact specs a full simulation uses.
    """
    vids = sorted(q.members)
    blocks = []
    for v in vids:
        p = q.proc[v]
        if p is None:
            raise ValueError(
                f"block {v} is unassigned — simulate needs a complete "
                "mapping (a feasible MappingResult)"
            )
        # the same float expression as the analytic recursion's
        # ``w_v / s_v`` term (bit-exactness anchor)
        blocks.append(BlockSpec(v, p, q.weight[v] / platform.procs[p].speed))
    edges = [EdgeSpec(u, w, c)
             for u in vids
             for w, c in sorted(q.succ[u].items())]
    return blocks, edges


def simulate(
    mapping,
    platform: Platform | None = None,
    *,
    comm="contention-free",
    jitter: float = 0.0,
    jitter_kind: str = "lognormal",
    replicas: int = 0,
    seed: int = 0,
    memory: bool = True,
    record_events: bool = True,
) -> SimReport:
    """Execute a mapping's schedule on a platform; returns a SimReport.

    ``mapping`` is a :class:`~repro_torch.core.baseline.MappingResult` or a
    :class:`~repro_torch.core.scheduler.ScheduleReport` (its ``best`` is
    used).  ``platform`` defaults to the mapping's own platform.

    ``comm`` selects the communication model: ``"contention-free"``
    (alias ``"paper"``) for the analytic model — under which, with no
    jitter, ``SimReport.makespan`` is bit-identical to the analytic
    :func:`repro_torch.core.makespan.makespan` — or ``"fair-share"`` (alias
    ``"contention"``) for fluid max-min fair link/port sharing; any
    object implementing the :mod:`repro_torch.sim.comm` protocol works.

    ``jitter > 0`` additionally replays ``replicas`` (default 16)
    seeded perturbations of the block durations and reports their
    makespans as ``SimReport.envelope``; the headline trace stays
    deterministic.  ``memory=False`` skips the occupancy tracker,
    ``record_events=False`` the event log (both for bulk sweeps).
    """
    res = getattr(mapping, "best", mapping)
    if res is None:
        raise ValueError(
            "schedule report has no feasible mapping to simulate "
            f"({getattr(mapping, 'infeasibility', None)})"
        )
    q = res.quotient
    platform = platform if platform is not None else res.platform
    blocks, edges = build_specs(q, platform)
    comm_model = resolve_comm(comm)

    trace = run_engine(blocks, edges, comm_model, platform,
                       record_events=record_events)

    procs_used = {b.proc for b in blocks}
    injective = len(procs_used) == len(blocks)
    contention_free = isinstance(comm_model, ContentionFreeComm)
    if contention_free and injective:
        # CPM backward pass: bit-exact canonical makespan (see engine).
        # Transposed edges swap each transfer's endpoints, so the link
        # view un-swaps them — asymmetric per-link overrides price the
        # same physical link in both passes.
        back = run_engine(blocks, transpose_edges(edges),
                          ContentionFreeComm(),
                          _ReversedLinkView(platform),
                          record_events=False)
        ms = back.horizon
    else:
        ms = trace.horizon
    exact_anchor = (contention_free and injective
                    and not platform.link_bandwidth)

    analytic = _analytic_makespan(q, platform)

    by_proc: dict[int, list[int]] = {}
    for b in sorted(blocks, key=lambda b: trace.start[b.vid]):
        by_proc.setdefault(b.proc, []).append(b.vid)
    span = ms if ms > 0 else 1.0
    procs = []
    for p in sorted(by_proc):
        busy = sum(trace.finish[v] - trace.start[v] for v in by_proc[p])
        procs.append(ProcUtilization(
            proc=p, name=platform.procs[p].name,
            blocks=tuple(by_proc[p]), busy_s=busy,
            idle_s=max(0.0, ms - busy), utilization=busy / span))

    mem_trace = None
    if memory:
        mem_trace = build_memory_trace(
            q.wf, q, platform, trace.start, trace.finish,
            orders=res.extras.get("orders"))

    envelope = None
    if jitter > 0.0:
        spec = JitterSpec(jitter, jitter_kind)
        n_rep = replicas if replicas > 0 else 16
        makespans = []
        for i in range(n_rep):
            f = spec.factors(len(blocks), seed, i)
            jb = [BlockSpec(b.vid, b.proc, b.duration * float(f[k]))
                  for k, b in enumerate(blocks)]
            jt = run_engine(jb, edges, comm_model, platform,
                            record_events=False)
            makespans.append(jt.horizon)
        envelope = JitterEnvelope(amount=jitter, kind=jitter_kind,
                                  seed=seed, makespans=makespans)

    transfers = [
        TransferRecord(src=e.src, dst=e.dst, volume=e.volume,
                       start=trace.xfer_start[(e.src, e.dst)],
                       finish=trace.xfer_finish[(e.src, e.dst)])
        for e in edges
    ]
    report = SimReport(
        comm=comm_model.name,
        makespan=ms,
        horizon=trace.horizon,
        analytic_makespan=analytic,
        exact_anchor=exact_anchor,
        platform_name=platform.name,
        n_tasks=q.wf.n,
        n_blocks=len(blocks),
        block_proc={b.vid: b.proc for b in blocks},
        block_start=dict(trace.start),
        block_finish=dict(trace.finish),
        transfers=transfers,
        procs=procs,
        events=trace.events,
        memory=mem_trace,
        envelope=envelope,
    )
    if platform.power or platform.failure_rates:
        from repro_torch.objectives import energy_from_sim  # deferred

        report.energy = energy_from_sim(report, platform)
    return report


def trace_memory(mapping, platform: Platform | None = None,
                 *, comm="contention-free") -> MemoryTrace:
    """Just the time-resolved memory trace of a mapping's schedule.

    One forward engine pass plus the occupancy tracker — the lean path
    ``validate_mapping(..., memory_trace=True)`` uses (no backward
    pass, no analytic sweep, no event/transfer bookkeeping).
    """
    res = getattr(mapping, "best", mapping)
    if res is None:
        raise ValueError("schedule report has no feasible mapping to trace")
    q = res.quotient
    platform = platform if platform is not None else res.platform
    blocks, edges = build_specs(q, platform)
    trace = run_engine(blocks, edges, resolve_comm(comm), platform,
                       record_events=False)
    return build_memory_trace(q.wf, q, platform, trace.start, trace.finish,
                              orders=res.extras.get("orders"))
