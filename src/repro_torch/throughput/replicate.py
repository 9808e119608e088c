"""Steady-state throughput analysis and plan replication.

Given one mapped plan (a feasible
:class:`~repro_torch.core.baseline.MappingResult`), repeated workflow
instances can be pipelined: instance ``i+1`` starts while instance ``i``
is still draining.  In steady state every processor must fit one
instance's worth of its work — compute *and*, optionally, its share of
inter-processor transfer occupancy — into each period, so the
sustainable period is the bottleneck processor's busy time per instance
(:func:`proc_busy_times`) and the rate its reciprocal.

When the platform has idle processors, the mapped *block groups* can be
replicated onto disjoint processor groups: each replica group hosts a
full copy of the mapping (block ``v`` of group ``g`` runs on
``plan.proc_for(g, q.proc[v])``), instances are dealt round-robin to
groups, and the aggregate rate becomes ``n_groups / max_g period_g``.
Replica processors are matched by *dominance* — a free processor stands
in for a used one only when its speed and memory are both at least as
large — so every replica inherits the original plan's memory
feasibility and its latency never exceeds the original's (under the
uniform-β analytic model that prices latency).

Group 0 is always the identity mapping on the original processors; with
``max_replicas=1`` the analysis degrades to pure steady-state pricing
of the unreplicated plan.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.platform import Platform

__all__ = [
    "proc_busy_times",
    "ReplicaGroup",
    "ThroughputPlan",
    "replicate_plan",
]


def proc_busy_times(
    q,
    platform: Platform,
    proc_of: dict[int, int] | None = None,
    include_comm: bool = True,
) -> dict[int, float]:
    """Busy time per processor for *one* workflow instance.

    Compute time of every hosted block, plus — when ``include_comm`` —
    the occupancy of every cross-processor transfer on both its egress
    and ingress endpoint (a serial-port model: the processor is tied up
    for ``c / β`` while the edge moves, matching how the engine's
    transfer log attributes intervals).  ``proc_of`` substitutes
    processors (base → replica) before pricing, so the same function
    prices every replica group.
    """
    pm = proc_of or {}
    busy: dict[int, float] = {}
    for v in sorted(q.members):
        p = q.proc[v]
        if p is None:
            raise ValueError(
                f"block {v} is unassigned — throughput analysis needs a "
                "complete mapping"
            )
        p = pm.get(p, p)
        busy[p] = busy.get(p, 0.0) + q.weight[v] / platform.procs[p].speed
    if include_comm:
        for u in sorted(q.members):
            pu = pm.get(q.proc[u], q.proc[u])
            for w, c in sorted(q.succ[u].items()):
                pw = pm.get(q.proc[w], q.proc[w])
                if pu == pw:
                    continue
                d = c / platform.bandwidth_between(pu, pw)
                busy[pu] = busy.get(pu, 0.0) + d
                busy[pw] = busy.get(pw, 0.0) + d
    return busy


def _group_latency(
    q, platform: Platform, proc_of: dict[int, int] | None = None
) -> float:
    """Analytic per-instance latency of one replica group.

    The bottom-weight recursion of :func:`repro_torch.core.makespan.makespan`
    with processor substitution: for the identity map the arithmetic is
    expression-for-expression identical, so the value is *bit-equal* to
    the plan's analytic makespan — the anchor the rate→0 identity test
    leans on.
    """
    pm = proc_of or {}
    beta = platform.bandwidth
    l: dict[int, float] = {}
    for v in reversed(q.topological_order()):
        p = pm.get(q.proc[v], q.proc[v])
        own = q.weight[v] / platform.procs[p].speed
        if not q.succ[v]:
            l[v] = own
        else:
            l[v] = own + max(
                c / beta + l[w] for w, c in q.succ[v].items()
            )
    return max(l.values()) if l else 0.0


@dataclass(frozen=True)
class ReplicaGroup:
    """One disjoint processor group hosting a full copy of the mapping.

    ``proc_map`` pairs every *used* base processor with its stand-in
    (identity pairs for group 0); ``period`` is the group's bottleneck
    busy time per instance, ``latency`` its analytic per-instance span.
    """

    proc_map: tuple[tuple[int, int], ...]
    period: float
    latency: float

    @property
    def procs(self) -> tuple[int, ...]:
        """The replica processors, in base-processor order."""
        return tuple(r for _, r in self.proc_map)

    def proc_for(self, base_proc: int) -> int:
        for b, r in self.proc_map:
            if b == base_proc:
                return r
        raise KeyError(f"processor {base_proc} is not used by the plan")

    def to_dict(self) -> dict:
        return {"proc_map": [list(pr) for pr in self.proc_map],
                "period": self.period, "latency": self.latency}

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicaGroup":
        return cls(proc_map=tuple((int(b), int(r))
                                  for b, r in d["proc_map"]),
                   period=d["period"], latency=d["latency"])


@dataclass(frozen=True)
class ThroughputPlan:
    """Replication + steady-state pricing of one mapped plan.

    ``rate`` is the sustainable aggregate throughput in instances per
    time unit under round-robin instance→group dealing:
    ``n_replicas / max_g period_g`` (the slowest group paces the deal).
    ``latency`` is the worst group's analytic per-instance latency —
    group 0's value is bit-equal to the plan's analytic makespan.
    """

    groups: tuple[ReplicaGroup, ...]
    period: float
    rate: float
    latency: float
    include_comm: bool = True
    latency_bound: float | None = None
    extras: dict = field(default_factory=dict, compare=False)

    @property
    def n_replicas(self) -> int:
        return len(self.groups)

    @property
    def used_procs(self) -> tuple[int, ...]:
        return tuple(b for b, _ in self.groups[0].proc_map)

    def proc_for(self, group: int, base_proc: int) -> int:
        return self.groups[group].proc_for(base_proc)

    def to_dict(self) -> dict:
        return {
            "groups": [g.to_dict() for g in self.groups],
            "period": self.period,
            "rate": self.rate,
            "latency": self.latency,
            "include_comm": self.include_comm,
            "latency_bound": self.latency_bound,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ThroughputPlan":
        return cls(
            groups=tuple(ReplicaGroup.from_dict(g) for g in d["groups"]),
            period=d["period"],
            rate=d["rate"],
            latency=d["latency"],
            include_comm=d.get("include_comm", True),
            latency_bound=d.get("latency_bound"),
        )


def replicate_plan(
    result,
    platform: Platform | None = None,
    *,
    max_replicas: int | None = None,
    include_comm: bool = True,
    latency_bound: float | None = None,
) -> ThroughputPlan:
    """Price and replicate a mapped plan for sustained traffic.

    Greedy dominance matching: base processors are considered hardest
    first (descending speed, then memory) and each is matched to the
    *tightest* still-free processor that dominates it (minimal speed,
    then memory — don't burn an A1 standing in for a local).  Matching
    stops at the first base processor with no dominating stand-in, at
    ``max_replicas`` total groups, or at the first group whose analytic
    latency exceeds ``latency_bound``.

    The returned plan is always non-empty (group 0 is the identity);
    callers enforce ``latency_bound`` on group 0 themselves — the
    scheduler's ``throughput`` stage turns that into a
    :class:`~repro_torch.core.scheduler.StageFailure`.
    """
    res = getattr(result, "best", result)
    if res is None:
        raise ValueError("schedule report has no feasible mapping to "
                         "replicate")
    q = res.quotient
    platform = platform if platform is not None else res.platform
    if max_replicas is not None and max_replicas < 1:
        raise ValueError(f"max_replicas must be >= 1, got {max_replicas}")

    busy0 = proc_busy_times(q, platform, include_comm=include_comm)
    used = sorted(busy0)
    identity = ReplicaGroup(
        proc_map=tuple((p, p) for p in used),
        period=max(busy0.values()),
        latency=_group_latency(q, platform),
    )
    groups = [identity]

    free = sorted(set(range(platform.k)) - set(used))
    # hardest-to-substitute base processors first
    order = sorted(
        used,
        key=lambda p: (-platform.procs[p].speed, -platform.procs[p].memory,
                       p),
    )
    while max_replicas is None or len(groups) < max_replicas:
        pm: dict[int, int] = {}
        taken: list[int] = []
        for b in order:
            sb, mb = platform.procs[b].speed, platform.procs[b].memory
            candidates = [
                j for j in free
                if j not in pm.values()
                and platform.procs[j].speed >= sb
                and platform.procs[j].memory >= mb
            ]
            if not candidates:
                pm = {}
                break
            j = min(candidates,
                    key=lambda j: (platform.procs[j].speed,
                                   platform.procs[j].memory, j))
            pm[b] = j
            taken.append(j)
        if not pm:
            break
        lat = _group_latency(q, platform, pm)
        if latency_bound is not None and lat > latency_bound:
            break
        busy = proc_busy_times(q, platform, pm, include_comm=include_comm)
        groups.append(ReplicaGroup(
            proc_map=tuple((b, pm[b]) for b in used),
            period=max(busy.values()),
            latency=lat,
        ))
        free = [j for j in free if j not in taken]

    worst_period = max(g.period for g in groups)
    return ThroughputPlan(
        groups=tuple(groups),
        period=worst_period,
        rate=len(groups) / worst_period if worst_period > 0 else 0.0,
        latency=max(g.latency for g in groups),
        include_comm=include_comm,
        latency_bound=latency_bound,
    )
