"""Structured results of a scenario run (:func:`repro_torch.scenario.run_scenario`).

A :class:`TimelineReport` stitches one :class:`SegmentReport` per
planning epoch: segment 0 runs the initial plan from ``t = 0``, each
platform event closes the current segment (freezing its executed
prefix) and opens the next with the replanned residual.  The report
carries the end-to-end makespan, the per-segment
:class:`~repro_torch.core.scheduler.ScheduleReport` /
:class:`~repro_torch.sim.SimReport` pairs, the migration log, ``to_json`` /
``from_json``, and a stitched ASCII Gantt with event markers.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

from repro_torch.core.baseline import MappingResult, validate_mapping
from repro_torch.core.platform import Platform
from repro_torch.core.scheduler import Infeasibility, ScheduleReport
from repro_torch.sim.report import SimReport

__all__ = ["MigrationRecord", "SegmentReport", "TimelineReport"]


@dataclass
class MigrationRecord:
    """What one replanning epoch moved.

    ``moved`` counts tasks whose block had a *surviving* processor but
    ends up elsewhere (a true migration — data would move);
    ``displaced`` counts tasks whose processor disappeared (forced to
    move); ``restarted`` counts in-flight tasks whose partial execution
    was discarded (no checkpointing — the restart semantics), with
    ``lost_work`` the operations thrown away (elapsed time × speed).
    ``moves`` lists ``[from_proc_name, to_proc_name, n_tasks]``
    triples, keyed by stable processor *names* (indices shift across
    failures).  ``checkpoint_decisions`` carries the per-in-flight-block
    restart-vs-migrate pricing verdicts from
    :func:`~repro_torch.scenario.runner.freeze_prefix` (``decision`` /
    ``restart_cost`` / ``migrate_cost`` / ``inputs_volume`` /
    ``applied`` per block).
    """

    time: float
    policy: str
    moved_tasks: int
    moved_blocks: int
    displaced_tasks: int
    displaced_blocks: int
    restarted_tasks: int
    restarted_blocks: int
    lost_work: float
    moves: list[list] = field(default_factory=list)
    checkpoint_decisions: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "time": self.time, "policy": self.policy,
            "moved_tasks": self.moved_tasks,
            "moved_blocks": self.moved_blocks,
            "displaced_tasks": self.displaced_tasks,
            "displaced_blocks": self.displaced_blocks,
            "restarted_tasks": self.restarted_tasks,
            "restarted_blocks": self.restarted_blocks,
            "lost_work": self.lost_work,
            "moves": [list(m) for m in self.moves],
            "checkpoint_decisions": [dict(c)
                                     for c in self.checkpoint_decisions],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MigrationRecord":
        return cls(**d)


@dataclass
class SegmentReport:
    """One planning epoch of a scenario timeline.

    ``report`` / ``sim`` describe the *plan* for this epoch and its
    as-planned execution (times relative to ``t_start``);
    ``executed_until`` is the relative time the segment actually ran
    before the next event cut it short (``None``: ran to completion).
    ``task_ids[i]`` maps the segment workflow's task ``i`` back to the
    scenario workflow's id.  The live ``mapping`` / ``platform`` /
    ``workflow`` objects ride along for validation and are excluded
    from JSON.
    """

    index: int
    t_start: float
    event: dict | None              # event that opened this segment
    platform_name: str
    n_procs: int
    n_tasks: int
    completed_before: int           # scenario tasks done before t_start
    report: ScheduleReport
    sim: SimReport | None
    executed_until: float | None
    task_ids: list[int]
    mapping: MappingResult | None = field(
        default=None, repr=False, compare=False)
    platform: Platform | None = field(
        default=None, repr=False, compare=False)

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "t_start": self.t_start,
            "event": self.event,
            "platform_name": self.platform_name,
            "n_procs": self.n_procs,
            "n_tasks": self.n_tasks,
            "completed_before": self.completed_before,
            "report": self.report.to_dict(),
            "sim": self.sim.to_dict() if self.sim else None,
            "executed_until": self.executed_until,
            "task_ids": list(self.task_ids),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SegmentReport":
        return cls(
            index=d["index"],
            t_start=d["t_start"],
            event=d.get("event"),
            platform_name=d["platform_name"],
            n_procs=d["n_procs"],
            n_tasks=d["n_tasks"],
            completed_before=d["completed_before"],
            report=ScheduleReport.from_dict(d["report"]),
            sim=SimReport.from_dict(d["sim"]) if d.get("sim") else None,
            executed_until=d.get("executed_until"),
            task_ids=list(d.get("task_ids", [])),
        )


@dataclass
class TimelineReport:
    """End-to-end record of a scenario execution — see module docstring.

    ``makespan`` is the stitched completion time (``None`` when a
    replan came back infeasible: ``feasible`` is ``False`` and
    ``infeasibility`` / ``failed_at`` say why and when).
    ``replan_times_s[i]`` is the wall-clock latency of the replan after
    event group ``i`` — the cold-vs-warm replan latency.
    """

    scenario: str
    policy: str
    segments: list[SegmentReport]
    events: list[dict]
    migrations: list[MigrationRecord]
    makespan: float | None
    feasible: bool
    infeasibility: Infeasibility | None
    failed_at: float | None
    total_time_s: float
    replan_times_s: list[float] = field(default_factory=list)

    # -------------------------------------------------------------- #
    @property
    def n_replans(self) -> int:
        return len(self.replan_times_s)

    def to_dict(self) -> dict:
        return {
            "scenario": self.scenario,
            "policy": self.policy,
            "segments": [s.to_dict() for s in self.segments],
            "events": [dict(e) for e in self.events],
            "migrations": [m.to_dict() for m in self.migrations],
            "makespan": self.makespan,
            "feasible": self.feasible,
            "infeasibility": (self.infeasibility.to_dict()
                              if self.infeasibility else None),
            "failed_at": self.failed_at,
            "total_time_s": self.total_time_s,
            "replan_times_s": list(self.replan_times_s),
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "TimelineReport":
        return cls(
            scenario=d["scenario"],
            policy=d["policy"],
            segments=[SegmentReport.from_dict(s)
                      for s in d.get("segments", [])],
            events=[dict(e) for e in d.get("events", [])],
            migrations=[MigrationRecord.from_dict(m)
                        for m in d.get("migrations", [])],
            makespan=d.get("makespan"),
            feasible=d.get("feasible", False),
            infeasibility=(Infeasibility.from_dict(d["infeasibility"])
                           if d.get("infeasibility") else None),
            failed_at=d.get("failed_at"),
            total_time_s=d.get("total_time_s", 0.0),
            replan_times_s=list(d.get("replan_times_s", [])),
        )

    @classmethod
    def from_json(cls, s: str) -> "TimelineReport":
        return cls.from_dict(json.loads(s))

    # -------------------------------------------------------------- #
    def validate(self, *, memory_trace: bool = True) -> list[str]:
        """All constraint violations across segments (empty = clean).

        Each segment's plan is checked with
        :func:`repro_torch.core.baseline.validate_mapping` against its own
        residual workflow and platform — the acceptance gate a stitched
        timeline must pass.
        """
        errors: list[str] = []
        for seg in self.segments:
            if seg.mapping is None:
                errors.append(
                    f"segment {seg.index}: live mapping unavailable "
                    "(deserialized report?)"
                )
                continue
            wf = seg.mapping.quotient.wf
            for e in validate_mapping(wf, seg.mapping,
                                      memory_trace=memory_trace):
                errors.append(f"segment {seg.index}: {e}")
        return errors

    # -------------------------------------------------------------- #
    def gantt(self, width: int = 72) -> str:
        """Stitched ASCII Gantt: rows are processors (stable names),
        columns span ``[0, makespan]``; ``▼`` ruler marks events.

        ``█`` executed compute, ``░`` in-flight work cut off by an
        event (restarted in the next segment), ``·`` idle.
        """
        if not self.segments:
            return "(no segments)"
        horizon = self.makespan
        if horizon is None:
            last = self.segments[-1]
            horizon = last.t_start + (last.executed_until
                                      or (last.sim.horizon
                                          if last.sim else 0.0))
        h = horizon if horizon > 0 else 1.0

        def col(t: float) -> int:
            return min(int(t / h * width), width - 1)

        rows: dict[str, list[str]] = {}
        order: list[str] = []

        def row(name: str) -> list[str]:
            if name not in rows:
                rows[name] = ["·"] * width
                order.append(name)
            return rows[name]

        for seg in self.segments:
            if seg.sim is None:
                continue
            cut = seg.executed_until
            names = {p.proc: p.name for p in seg.sim.procs}
            for vid, p in seg.sim.block_proc.items():
                s = seg.sim.block_start[vid]
                f = seg.sim.block_finish[vid]
                if cut is not None and s >= cut:
                    continue  # never started in this epoch
                mark = "█"
                if cut is not None and f > cut:
                    f = cut   # in-flight at the event: lost/restarted
                    mark = "░"
                a = col(seg.t_start + s)
                b = max(a + 1, min(int(math.ceil(
                    (seg.t_start + f) / h * width)), width))
                r = row(names.get(p, f"p{p}"))
                for x in range(a, b):
                    r[x] = mark
                label = str(vid)
                if mark == "█" and b - a >= len(label) + 2:
                    r[a + 1:a + 1 + len(label)] = label

        ruler = [" "] * width
        for e in self.events:
            t = e.get("time")
            if t is not None and t <= h:
                ruler[col(t)] = "▼"
        lines = [f"{'':>14s}t=0{'':{max(width - 11, 1)}s}t={h:.6g}"]
        if any(c != " " for c in ruler):
            lines.append(f"{'events':>12.12s}  {''.join(ruler)}")
        for name in order:
            lines.append(f"{name:>12.12s} |{''.join(rows[name])}|")
        legend = [f"t={e['time']:g}: {e.get('detail', e['kind'])}"
                  for e in self.events]
        if legend:
            lines.append("  ▼ " + "; ".join(legend))
        return "\n".join(lines)
