"""Structured results of a schedule replay (:func:`repro_torch.sim.simulate`).

A :class:`SimReport` is the simulation analogue of
:class:`repro_torch.core.scheduler.ScheduleReport`: a JSON-serializable record
of *what happened* when a mapping was executed on a platform — block
start/finish times, per-processor utilization, the transfer log, the
time-resolved memory occupancy (with violations), and the robustness
envelope under stochastic task durations.

``makespan`` vs ``horizon``
---------------------------
``horizon`` is the last block-finish time of the forward (ASAP) replay
— the value every trace artifact (Gantt, events, memory timeline) is
consistent with.  ``makespan`` is the canonical simulated makespan: in
the deterministic contention-free regime it comes from the engine's CPM
backward pass, whose per-op float roundings mirror the analytic
bottom-weight recursion exactly (see :mod:`repro_torch.sim.engine`), so it is
*bit-identical* to :func:`repro_torch.core.makespan.makespan` — that is the
subsystem's correctness anchor, and ``exact_anchor`` records when it is
in force.  Under contention or jitter there is no analytic counterpart
and ``makespan == horizon``.  The two regimes agree to float round-off.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

__all__ = [
    "SimEvent",
    "TransferRecord",
    "ProcUtilization",
    "MemoryViolation",
    "MemoryTrace",
    "JitterEnvelope",
    "SimReport",
]


@dataclass(frozen=True)
class SimEvent:
    """One entry of the event log.

    ``kind`` is one of ``task_start`` / ``task_finish`` (a quotient
    block beginning/ending its compute interval on ``proc``) or
    ``transfer_start`` / ``transfer_finish`` (the aggregated quotient
    edge ``edge`` moving between processors).
    """

    time: float
    kind: str
    vertex: int | None = None
    edge: tuple[int, int] | None = None
    proc: int | None = None

    def to_list(self) -> list:
        return [self.time, self.kind, self.vertex,
                list(self.edge) if self.edge else None, self.proc]

    @classmethod
    def from_list(cls, row: list) -> "SimEvent":
        t, kind, vertex, edge, proc = row
        return cls(time=t, kind=kind, vertex=vertex,
                   edge=tuple(edge) if edge else None, proc=proc)


@dataclass(frozen=True)
class TransferRecord:
    """One aggregated inter-block transfer, with its realized interval
    (under contention the duration exceeds ``volume / β``)."""

    src: int
    dst: int
    volume: float
    start: float
    finish: float

    def to_list(self) -> list:
        return [self.src, self.dst, self.volume, self.start, self.finish]

    @classmethod
    def from_list(cls, row: list) -> "TransferRecord":
        return cls(*row)


@dataclass(frozen=True)
class ProcUtilization:
    """Busy/idle accounting for one processor that hosts blocks."""

    proc: int
    name: str
    blocks: tuple[int, ...]
    busy_s: float
    idle_s: float
    utilization: float

    def to_dict(self) -> dict:
        return {
            "proc": self.proc, "name": self.name,
            "blocks": list(self.blocks), "busy_s": self.busy_s,
            "idle_s": self.idle_s, "utilization": self.utilization,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProcUtilization":
        d = dict(d)
        d["blocks"] = tuple(d["blocks"])
        return cls(**d)


@dataclass(frozen=True)
class MemoryViolation:
    """An instant where a processor's occupancy exceeds its memory.

    ``instance`` pinpoints the workflow instance whose task pushed the
    occupancy over in pipelined multi-instance replays
    (the throughput analysis); ``None`` for single-instance traces.
    """

    time: float
    proc: int
    vertex: int
    task: int
    occupancy: float
    capacity: float
    instance: int | None = None

    def to_dict(self) -> dict:
        d = {
            "time": self.time, "proc": self.proc, "vertex": self.vertex,
            "task": self.task, "occupancy": self.occupancy,
            "capacity": self.capacity,
        }
        if self.instance is not None:
            d["instance"] = self.instance
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "MemoryViolation":
        return cls(**d)


@dataclass
class MemoryTrace:
    """Time-resolved memory occupancy per processor.

    ``per_proc[j]`` is the step function as ``(time, occupancy)``
    breakpoints (occupancy holds from each point to the next);
    ``peak[j]`` its maximum; ``violations`` every sampled instant whose
    occupancy exceeded the processor memory (sorted by time, capped at
    the tracker's ``violation_limit``).
    """

    per_proc: dict[int, list[tuple[float, float]]]
    peak: dict[int, float]
    violations: list[MemoryViolation] = field(default_factory=list)

    @property
    def feasible(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "per_proc": [[j, [list(pt) for pt in pts]]
                         for j, pts in sorted(self.per_proc.items())],
            "peak": [[j, v] for j, v in sorted(self.peak.items())],
            "violations": [v.to_dict() for v in self.violations],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MemoryTrace":
        return cls(
            per_proc={j: [tuple(pt) for pt in pts]
                      for j, pts in d["per_proc"]},
            peak={j: v for j, v in d["peak"]},
            violations=[MemoryViolation.from_dict(v)
                        for v in d.get("violations", [])],
        )


@dataclass
class JitterEnvelope:
    """Makespans of N replicas with stochastically perturbed durations."""

    amount: float
    kind: str
    seed: int
    makespans: list[float]

    @property
    def lo(self) -> float:
        return min(self.makespans)

    @property
    def hi(self) -> float:
        return max(self.makespans)

    @property
    def mean(self) -> float:
        return sum(self.makespans) / len(self.makespans)

    @property
    def std(self) -> float:
        m = self.mean
        return math.sqrt(sum((x - m) ** 2 for x in self.makespans)
                         / len(self.makespans))

    def to_dict(self) -> dict:
        return {"amount": self.amount, "kind": self.kind,
                "seed": self.seed, "makespans": list(self.makespans)}

    @classmethod
    def from_dict(cls, d: dict) -> "JitterEnvelope":
        return cls(**d)


@dataclass
class SimReport:
    """Everything :func:`repro_torch.sim.simulate` observed — see the module
    docstring for the ``makespan`` / ``horizon`` distinction."""

    comm: str
    makespan: float
    horizon: float
    analytic_makespan: float | None
    exact_anchor: bool
    platform_name: str
    n_tasks: int
    n_blocks: int
    block_proc: dict[int, int]
    block_start: dict[int, float]
    block_finish: dict[int, float]
    transfers: list[TransferRecord]
    procs: list[ProcUtilization]
    events: list[SimEvent] = field(default_factory=list)
    memory: MemoryTrace | None = None
    envelope: JitterEnvelope | None = None
    #: energy/exposure accounting from the per-proc busy integrals
    #: (:func:`repro_torch.objectives.energy_from_sim`) — attached when the
    #: platform carries a failure or power model, else ``None``
    energy: dict | None = None

    # -------------------------------------------------------------- #
    def to_dict(self) -> dict:
        return {
            "comm": self.comm,
            "makespan": self.makespan,
            "horizon": self.horizon,
            "analytic_makespan": self.analytic_makespan,
            "exact_anchor": self.exact_anchor,
            "platform_name": self.platform_name,
            "n_tasks": self.n_tasks,
            "n_blocks": self.n_blocks,
            "blocks": [[v, self.block_proc[v], self.block_start[v],
                        self.block_finish[v]]
                       for v in sorted(self.block_proc)],
            "transfers": [t.to_list() for t in self.transfers],
            "procs": [p.to_dict() for p in self.procs],
            "events": [e.to_list() for e in self.events],
            "memory": self.memory.to_dict() if self.memory else None,
            "envelope": self.envelope.to_dict() if self.envelope else None,
            "energy": self.energy,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "SimReport":
        blocks = d.get("blocks", [])
        return cls(
            comm=d["comm"],
            makespan=d["makespan"],
            horizon=d["horizon"],
            analytic_makespan=d.get("analytic_makespan"),
            exact_anchor=d.get("exact_anchor", False),
            platform_name=d.get("platform_name", "?"),
            n_tasks=d.get("n_tasks", 0),
            n_blocks=d.get("n_blocks", len(blocks)),
            block_proc={v: p for v, p, _, _ in blocks},
            block_start={v: s for v, _, s, _ in blocks},
            block_finish={v: f for v, _, _, f in blocks},
            transfers=[TransferRecord.from_list(t)
                       for t in d.get("transfers", [])],
            procs=[ProcUtilization.from_dict(p) for p in d.get("procs", [])],
            events=[SimEvent.from_list(e) for e in d.get("events", [])],
            memory=(MemoryTrace.from_dict(d["memory"])
                    if d.get("memory") else None),
            envelope=(JitterEnvelope.from_dict(d["envelope"])
                      if d.get("envelope") else None),
            energy=d.get("energy"),
        )

    @classmethod
    def from_json(cls, s: str) -> "SimReport":
        return cls.from_dict(json.loads(s))

    # -------------------------------------------------------------- #
    def gantt(self, width: int = 64) -> str:
        """ASCII Gantt chart: one row per block-hosting processor.

        ``█`` marks the block's compute interval (its id is inlaid when
        it fits), ``·`` idle time.  The axis spans ``[0, horizon]``.
        """
        h = self.horizon if self.horizon > 0 else 1.0
        lines = [f"{'':>14s}  t=0{'':{max(width - 12, 1)}s}"
                 f"t={h:.6g}"]
        for pu in sorted(self.procs, key=lambda p: p.proc):
            row = ["·"] * width
            for vid in pu.blocks:
                s, f = self.block_start[vid], self.block_finish[vid]
                a = min(int(s / h * width), width - 1)
                b = max(a + 1, min(int(math.ceil(f / h * width)), width))
                for x in range(a, b):
                    row[x] = "█"
                label = str(vid)
                if b - a >= len(label) + 2:
                    row[a + 1:a + 1 + len(label)] = label
            lines.append(f"{pu.name:>12.12s}  |{''.join(row)}| "
                         f"busy {pu.utilization:6.1%}")
        return "\n".join(lines)
