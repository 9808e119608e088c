"""Pipelined multi-instance replay of a replicated plan.

:func:`build_pipelined_specs` lowers N instances of one mapped workflow
into a single engine problem: instance ``i`` occupies the disjoint vid
range ``[i*stride, (i+1)*stride)`` (``stride`` = max base vid + 1, so
instance 0 keeps the original vids — the identity anchor relies on
that), runs on its round-robin replica group's processors, and is
*released* at its arrival instant.  One :func:`repro_torch.sim.run_engine`
pass then replays all instances together: the engine's per-processor
serialization and the communication model are the interference model —
instance ``i+1``'s sources overlap instance ``i``'s sinks wherever the
plan leaves room, and queue behind them where it does not.

:func:`simulate_pipelined` wraps the pass into a
:class:`PipelinedReport` with per-instance latencies, the achieved
rate, the canonical single-instance makespan (computed exactly as
:func:`repro_torch.sim.simulate` computes it — the rate→0 identity anchor),
and a time-resolved memory occupancy trace summed across in-flight
instances, each transient violation pinpointed to the instance whose
task pushed the processor over.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.memdag import occupancy_steps
from repro_torch.core.platform import Platform
from repro_torch.sim import (
    _ReversedLinkView,
    build_specs,
    resolve_comm,
    run_engine,
    transpose_edges,
)
from repro_torch.sim.comm import ContentionFreeComm
from repro_torch.sim.engine import BlockSpec, EdgeSpec
from repro_torch.sim.memory import pick_block_order
from repro_torch.sim.report import (
    MemoryTrace,
    MemoryViolation,
    SimEvent,
    TransferRecord,
)

from .arrivals import ArrivalSpec
from .replicate import ThroughputPlan, replicate_plan

__all__ = [
    "InstanceRecord",
    "PipelinedReport",
    "build_pipelined_specs",
    "simulate_pipelined",
]

#: relative slack mirroring repro_torch.sim.memory._TOL
_TOL = 1 + 1e-9


@dataclass(frozen=True)
class InstanceRecord:
    """One workflow instance's journey through the pipelined replay."""

    instance: int
    replica: int
    arrival: float
    start: float
    finish: float

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    def to_list(self) -> list:
        return [self.instance, self.replica, self.arrival,
                self.start, self.finish]

    @classmethod
    def from_list(cls, row: list) -> "InstanceRecord":
        return cls(*row)


def build_pipelined_specs(
    q,
    platform: Platform,
    plan: ThroughputPlan,
    arrivals,
):
    """Lower N instances into one engine problem.

    Returns ``(blocks, edges, release, stride)``.  ``arrivals`` is the
    sequence of instance arrival instants (its length sets N); instance
    ``i`` runs on replica group ``i % plan.n_replicas`` and every one
    of its blocks carries a release floor at its arrival.  Instance 0's
    vids equal the base vids and, at arrival 0 on group 0 (the identity
    group), its specs are *bit-identical* to
    :func:`repro_torch.sim.build_specs` — the anchor below.
    """
    arrivals = [float(a) for a in arrivals]
    if not arrivals:
        raise ValueError("need at least one arrival")
    if any(a < 0 for a in arrivals):
        raise ValueError("arrival times must be >= 0")
    vids = sorted(q.members)
    stride = max(vids) + 1
    n_rep = plan.n_replicas
    blocks: list[BlockSpec] = []
    edges: list[EdgeSpec] = []
    release: dict[int, float] = {}
    for i, t_arr in enumerate(arrivals):
        g = i % n_rep
        off = i * stride
        for v in vids:
            p = plan.proc_for(g, q.proc[v])
            # same float expression as build_specs (bit-exactness)
            blocks.append(BlockSpec(
                off + v, p, q.weight[v] / platform.procs[p].speed))
            release[off + v] = t_arr
        edges.extend(EdgeSpec(off + u, off + w, c)
                     for u in vids
                     for w, c in sorted(q.succ[u].items()))
    return blocks, edges, release, stride


def _pipelined_memory_trace(
    wf, q, platform: Platform, plan: ThroughputPlan,
    start: dict[int, float], finish: dict[int, float],
    stride: int, n_instances: int,
    orders: dict[int, list[int]] | None = None,
    *, violation_limit: int = 64,
) -> MemoryTrace:
    """Occupancy summed across in-flight instances, per processor.

    Each instance's blocks contribute the same step function the
    single-instance tracker (:mod:`repro_torch.sim.memory`) builds; here the
    steps become deltas accumulated per processor, so overlapping
    instances *sum* — and a transient violation names the instance
    whose task start pushed the occupancy over (``MemoryViolation
    .instance``).  Same memory model, same ``1e-9`` relative slack.
    """
    orders = orders or {}
    # (t, neg-before-pos, seq) -> delta, marker
    deltas: dict[int, list[tuple[float, int, int, float, tuple | None]]] = {}
    seq = 0
    for i in range(n_instances):
        g = i % plan.n_replicas
        off = i * stride
        for v in sorted(q.members):
            members = q.members[v]
            p = plan.proc_for(g, q.proc[v])
            speed = platform.procs[p].speed
            order = pick_block_order(wf, members, orders.get(v))
            base = sum(wf.persistent[u] for u in members)
            points: list[tuple[float, float, tuple | None]] = []
            t = start[off + v]
            points.append((t, base, None))
            for u, during, live_after in occupancy_steps(wf, members,
                                                         order):
                points.append((t, base + during, (i, v, u)))
                t = t + wf.work[u] / speed
                points.append((t, base + live_after, None))
            points.append((finish[off + v], 0.0, None))
            bucket = deltas.setdefault(p, [])
            prev = 0.0
            for t, val, marker in points:
                d = val - prev
                prev = val
                if d != 0.0 or marker is not None:
                    bucket.append((t, 0 if d < 0.0 else 1, seq, d, marker))
                    seq += 1

    per_proc: dict[int, list[tuple[float, float]]] = {}
    peak: dict[int, float] = {}
    violations: list[MemoryViolation] = []
    for p in sorted(deltas):
        cap = platform.memory(p)
        running = 0.0
        pts = per_proc.setdefault(p, [])
        for t, _, _, d, marker in sorted(deltas[p], key=lambda r: r[:3]):
            running += d
            pts.append((t, running))
            if running > peak.get(p, 0.0):
                peak[p] = running
            if (marker is not None and running > cap * _TOL
                    and len(violations) < violation_limit):
                inst, v, u = marker
                violations.append(MemoryViolation(
                    time=t, proc=p, vertex=v, task=u,
                    occupancy=running, capacity=cap, instance=inst))
    violations.sort(key=lambda v: (v.time, v.proc, v.task))
    return MemoryTrace(per_proc=per_proc, peak=peak, violations=violations)


@dataclass
class PipelinedReport:
    """What a pipelined N-instance replay observed.

    ``single_makespan`` is the canonical single-instance makespan
    computed exactly as :func:`repro_torch.sim.simulate` computes it (CPM
    backward pass in the contention-free injective regime) — with one
    instance arriving at 0 it is bit-identical to
    ``simulate(...).makespan``, the subsystem's identity anchor, and
    ``exact_anchor`` records when that regime is in force.
    """

    comm: str
    n_instances: int
    n_replicas: int
    stride: int
    horizon: float
    achieved_rate: float
    single_makespan: float
    exact_anchor: bool
    instances: list[InstanceRecord]
    block_proc: dict[int, int]
    block_start: dict[int, float]
    block_finish: dict[int, float]
    transfers: list[TransferRecord] = field(default_factory=list)
    events: list[SimEvent] = field(default_factory=list)
    memory: MemoryTrace | None = None

    @property
    def latencies(self) -> list[float]:
        return [r.latency for r in self.instances]

    def percentile_latency(self, pct: float) -> float:
        """Exact percentile over the recorded instance latencies."""
        return float(np.percentile(np.asarray(self.latencies), pct))

    def to_dict(self) -> dict:
        return {
            "comm": self.comm,
            "n_instances": self.n_instances,
            "n_replicas": self.n_replicas,
            "stride": self.stride,
            "horizon": self.horizon,
            "achieved_rate": self.achieved_rate,
            "single_makespan": self.single_makespan,
            "exact_anchor": self.exact_anchor,
            "instances": [r.to_list() for r in self.instances],
            "blocks": [[v, self.block_proc[v], self.block_start[v],
                        self.block_finish[v]]
                       for v in sorted(self.block_proc)],
            "transfers": [t.to_list() for t in self.transfers],
            "events": [e.to_list() for e in self.events],
            "memory": self.memory.to_dict() if self.memory else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PipelinedReport":
        blocks = d.get("blocks", [])
        return cls(
            comm=d["comm"],
            n_instances=d["n_instances"],
            n_replicas=d["n_replicas"],
            stride=d["stride"],
            horizon=d["horizon"],
            achieved_rate=d["achieved_rate"],
            single_makespan=d["single_makespan"],
            exact_anchor=d.get("exact_anchor", False),
            instances=[InstanceRecord.from_list(r)
                       for r in d.get("instances", [])],
            block_proc={v: p for v, p, _, _ in blocks},
            block_start={v: s for v, _, s, _ in blocks},
            block_finish={v: f for v, _, _, f in blocks},
            transfers=[TransferRecord.from_list(t)
                       for t in d.get("transfers", [])],
            events=[SimEvent.from_list(e) for e in d.get("events", [])],
            memory=(MemoryTrace.from_dict(d["memory"])
                    if d.get("memory") else None),
        )


def simulate_pipelined(
    mapping,
    platform: Platform | None = None,
    *,
    arrivals=None,
    n_instances: int = 8,
    rate: float | None = None,
    arrival_kind: str = "poisson",
    seed: int = 0,
    plan: ThroughputPlan | None = None,
    comm="contention-free",
    memory: bool = True,
    record_events: bool = False,
    max_replicas: int | None = None,
    include_comm: bool = True,
) -> PipelinedReport:
    """Replay ``n_instances`` arrivals of one mapped plan, pipelined.

    ``arrivals`` is an :class:`~repro_torch.throughput.arrivals.ArrivalSpec`,
    an explicit sequence of instants, or ``None`` — then ``rate`` plus
    ``arrival_kind`` build one.  ``plan`` is the replication to use
    (default: :func:`~repro_torch.throughput.replicate.replicate_plan` of the
    mapping).  One instance arriving at 0 reproduces
    ``simulate(mapping, platform)`` bit-exactly (same specs, same
    engine, same backward pass).
    """
    res = getattr(mapping, "best", mapping)
    if res is None:
        raise ValueError("schedule report has no feasible mapping to "
                         "replay")
    q = res.quotient
    platform = platform if platform is not None else res.platform
    if plan is None:
        plan = replicate_plan(res, platform, max_replicas=max_replicas,
                              include_comm=include_comm)
    if arrivals is None:
        if rate is None:
            raise ValueError("pass arrivals= or rate=")
        arrivals = ArrivalSpec(rate, arrival_kind)
    if isinstance(arrivals, ArrivalSpec):
        arrivals = arrivals.times(n_instances, seed)
    arrivals = [float(a) for a in arrivals]
    n = len(arrivals)

    blocks, edges, release, stride = build_pipelined_specs(
        q, platform, plan, arrivals)
    comm_model = resolve_comm(comm)
    trace = run_engine(blocks, edges, comm_model, platform,
                       record_events=record_events, release=release)

    # canonical single-instance makespan, exactly as simulate() does
    base_blocks, base_edges = build_specs(q, platform)
    procs_used = {b.proc for b in base_blocks}
    injective = len(procs_used) == len(base_blocks)
    contention_free = isinstance(comm_model, ContentionFreeComm)
    if contention_free and injective:
        back = run_engine(base_blocks, transpose_edges(base_edges),
                          ContentionFreeComm(), _ReversedLinkView(platform),
                          record_events=False)
        single_ms = back.horizon
    else:
        solo = run_engine(base_blocks, base_edges, resolve_comm(comm),
                          platform, record_events=False)
        single_ms = solo.horizon
    exact_anchor = (contention_free and injective
                    and not platform.link_bandwidth)

    vids = sorted(q.members)
    instances = []
    for i, t_arr in enumerate(arrivals):
        off = i * stride
        instances.append(InstanceRecord(
            instance=i,
            replica=i % plan.n_replicas,
            arrival=t_arr,
            start=min(trace.start[off + v] for v in vids),
            finish=max(trace.finish[off + v] for v in vids),
        ))
    span = instances[-1].finish - min(r.arrival for r in instances)
    achieved = n / span if span > 0 else 0.0

    mem_trace = None
    if memory:
        mem_trace = _pipelined_memory_trace(
            q.wf, q, platform, plan, trace.start, trace.finish,
            stride, n, orders=res.extras.get("orders"))

    transfers = [
        TransferRecord(src=e.src, dst=e.dst, volume=e.volume,
                       start=trace.xfer_start[(e.src, e.dst)],
                       finish=trace.xfer_finish[(e.src, e.dst)])
        for e in edges
    ]
    return PipelinedReport(
        comm=comm_model.name,
        n_instances=n,
        n_replicas=plan.n_replicas,
        stride=stride,
        horizon=trace.horizon,
        achieved_rate=achieved,
        single_makespan=single_ms,
        exact_anchor=exact_anchor,
        instances=instances,
        block_proc={b.vid: b.proc for b in blocks},
        block_start=dict(trace.start),
        block_finish=dict(trace.finish),
        transfers=transfers,
        events=trace.events,
        memory=mem_trace,
    )
