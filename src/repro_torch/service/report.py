"""Service outcomes: per-job records, the deterministic trace, the report.

The split mirrors the determinism contract: a :class:`ServiceTrace` is
the pure **virtual-time** record of a run — per-job lifecycle times,
outcomes, mappings, the platform-utilization timeline, the event/log
stream — and round-trips through JSON bit-identically for the same
submission trace, whatever the wall clock or worker count did.  The
:class:`ServiceReport` wraps the trace together with the
*non-deterministic* observability: wall-clock planning latencies per
path (cold / seeded / replan) and the :mod:`repro_torch.core.counters` delta
(``cache_stats``).  Tests compare traces; benchmarks read reports.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = ["JobRecord", "ServiceReport", "ServiceTrace"]

_TERMINAL = ("completed", "infeasible", "rejected")


@dataclass
class JobRecord:
    """One submission's full lifecycle, in virtual time.

    ``status`` is terminal and exclusive: ``"completed"``,
    ``"infeasible"`` (admitted, but no feasible plan even with the
    platform to itself — carries the structured ``infeasibility``
    dict), or ``"rejected"`` (never admitted — carries the
    ``rejection`` dict).  ``planning_path`` is ``"cold"`` or
    ``"seeded"`` (plan-cache hit); ``mapping`` is the final mapping
    summary (wall-clock ``runtime_s`` scrubbed to keep the trace
    deterministic).  ``makespan`` spans dispatch → finish and includes
    any mid-run replan stitches; ``queue_wait`` spans arrival →
    dispatch.
    """

    job_id: int
    name: str
    tenant: str
    arrival_t: float
    status: str
    deadline: float | None = None
    n_tasks: int | None = None
    fingerprint: str | None = None
    dispatch_t: float | None = None
    finish_t: float | None = None
    queue_wait: float | None = None
    latency: float | None = None
    makespan: float | None = None
    deadline_met: bool | None = None
    planning_path: str | None = None
    k_prime: int | None = None
    n_replans: int = 0
    n_deferrals: int = 0
    allocation: list[str] = field(default_factory=list)
    mapping: dict | None = None
    rejection: dict | None = None
    infeasibility: dict | None = None

    def __post_init__(self) -> None:
        if self.status not in _TERMINAL:
            raise ValueError(
                f"status must be one of {_TERMINAL}, got {self.status!r}")

    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id, "name": self.name,
            "tenant": self.tenant, "arrival_t": self.arrival_t,
            "status": self.status, "deadline": self.deadline,
            "n_tasks": self.n_tasks, "fingerprint": self.fingerprint,
            "dispatch_t": self.dispatch_t, "finish_t": self.finish_t,
            "queue_wait": self.queue_wait, "latency": self.latency,
            "makespan": self.makespan,
            "deadline_met": self.deadline_met,
            "planning_path": self.planning_path,
            "k_prime": self.k_prime,
            "n_replans": self.n_replans,
            "n_deferrals": self.n_deferrals,
            "allocation": list(self.allocation),
            "mapping": self.mapping,
            "rejection": self.rejection,
            "infeasibility": self.infeasibility,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "JobRecord":
        return cls(**{k: d.get(k) for k in (
            "job_id", "name", "tenant", "arrival_t", "status",
            "deadline", "n_tasks", "fingerprint", "dispatch_t",
            "finish_t", "queue_wait", "latency", "makespan",
            "deadline_met", "planning_path", "k_prime",
            "mapping", "rejection", "infeasibility",
        )} | {
            "n_replans": int(d.get("n_replans", 0)),
            "n_deferrals": int(d.get("n_deferrals", 0)),
            "allocation": list(d.get("allocation", [])),
        })


@dataclass
class ServiceTrace:
    """Deterministic virtual-time record of one service run.

    ``log`` is the chronological service log (admit / reject / defer /
    dispatch / event / replan / complete entries, each a plain dict
    with ``t`` and ``kind``); ``utilization`` is the busy-processor
    timeline as ``[t, busy, k]`` change points; ``horizon`` is the last
    virtual instant anything happened.
    """

    name: str
    platform_name: str
    n_procs: int
    jobs: list[JobRecord] = field(default_factory=list)
    events: list[dict] = field(default_factory=list)
    log: list[dict] = field(default_factory=list)
    utilization: list[list] = field(default_factory=list)
    horizon: float = 0.0
    busy_proc_time: float = 0.0

    # -------------------------------------------------------------- #
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "platform_name": self.platform_name,
            "n_procs": self.n_procs,
            "jobs": [j.to_dict() for j in self.jobs],
            "events": list(self.events),
            "log": list(self.log),
            "utilization": [list(u) for u in self.utilization],
            "horizon": self.horizon,
            "busy_proc_time": self.busy_proc_time,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceTrace":
        return cls(
            name=d["name"], platform_name=d["platform_name"],
            n_procs=int(d["n_procs"]),
            jobs=[JobRecord.from_dict(j) for j in d.get("jobs", [])],
            events=list(d.get("events", [])),
            log=list(d.get("log", [])),
            utilization=[list(u) for u in d.get("utilization", [])],
            horizon=float(d.get("horizon", 0.0)),
            busy_proc_time=float(d.get("busy_proc_time", 0.0)),
        )

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ServiceTrace":
        return cls.from_dict(json.loads(s))


@dataclass
class ServiceReport:
    """Trace + wall-clock observability for one service run.

    ``metrics`` is the run's non-counter metrics block
    (``{"gauges": ..., "histograms": ...}``, sparse — see
    :mod:`repro_torch.obs.metrics`): the ``service_plan_latency_s``,
    ``service_queue_wait`` and ``service_makespan_premium`` histograms
    live here, and the percentile properties below derive from them.
    ``spans`` carries the run's finished tracer spans when
    ``ServiceConfig.obs`` enabled tracing (live objects — excluded
    from JSON and equality); ``pipelined`` likewise carries the live
    :class:`~repro_torch.throughput.pipeline.PipelinedReport` of a
    :func:`~repro_torch.service.sustained.run_sustained` replay.
    """

    trace: ServiceTrace
    cache_stats: dict = field(default_factory=dict)
    plan_wall_s: dict = field(default_factory=dict)  # path -> [seconds]
    total_time_s: float = 0.0
    metrics: dict = field(default_factory=dict)
    spans: list = field(default_factory=list, repr=False, compare=False)
    pipelined: object | None = field(default=None, repr=False,
                                     compare=False)

    # convenience views ------------------------------------------------ #
    @property
    def jobs(self) -> list[JobRecord]:
        return self.trace.jobs

    def by_status(self, status: str) -> list[JobRecord]:
        return [j for j in self.trace.jobs if j.status == status]

    @property
    def completed(self) -> list[JobRecord]:
        return self.by_status("completed")

    @property
    def rejected(self) -> list[JobRecord]:
        return self.by_status("rejected")

    @property
    def infeasible(self) -> list[JobRecord]:
        return self.by_status("infeasible")

    @property
    def cache_hit_rate(self) -> float | None:
        hits = self.cache_stats.get("service_cache_hits", 0)
        misses = self.cache_stats.get("service_cache_misses", 0)
        if hits + misses == 0:
            return None
        return hits / (hits + misses)

    @property
    def utilization(self) -> float | None:
        """Mean fraction of the platform busy over the horizon."""
        tr = self.trace
        if tr.horizon <= 0 or tr.n_procs == 0:
            return None
        return tr.busy_proc_time / (tr.horizon * tr.n_procs)

    # histogram-derived percentiles ------------------------------------ #
    def _hist_percentiles(self, name: str) -> dict | None:
        from repro_torch.obs.metrics import percentiles

        return percentiles(
            self.metrics.get("histograms", {}).get(name, {}))

    @property
    def plan_latency_percentiles(self) -> dict | None:
        """``{"p50": ..., "p95": ..., "p99": ...}`` of wall-clock
        planning latency (seconds, all paths), or ``None``."""
        return self._hist_percentiles("service_plan_latency_s")

    @property
    def queue_wait_percentiles(self) -> dict | None:
        """p50/p95/p99 of virtual-time arrival→dispatch wait."""
        return self._hist_percentiles("service_queue_wait")

    @property
    def makespan_premium_percentiles(self) -> dict | None:
        """p50/p95/p99 of the seeded-plan makespan premium (ratio vs
        the cached winner; ``None`` without plan-cache hits)."""
        return self._hist_percentiles("service_makespan_premium")

    # sustained-stream views (run_sustained) --------------------------- #
    @property
    def instance_latency_percentiles(self) -> dict | None:
        """p50/p95/p99 of per-instance arrival→finish latency in a
        sustained run (virtual time), or ``None``."""
        return self._hist_percentiles("sustained_instance_latency")

    @property
    def instances_per_s(self) -> float | None:
        """Achieved throughput of a sustained run (instances per
        virtual time unit), or ``None``."""
        return self.metrics.get("gauges", {}).get(
            "sustained_instances_per_s")

    @property
    def saturation_rate(self) -> float | None:
        """The plan's analytic sustainable rate — offered rates beyond
        it saturate the pipeline; ``None`` outside sustained runs."""
        return self.metrics.get("gauges", {}).get(
            "sustained_saturation_rate")

    # serialization ---------------------------------------------------- #
    def to_dict(self) -> dict:
        return {
            "trace": self.trace.to_dict(),
            "cache_stats": dict(self.cache_stats),
            "plan_wall_s": {k: list(v)
                            for k, v in self.plan_wall_s.items()},
            "total_time_s": self.total_time_s,
            "metrics": dict(self.metrics),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceReport":
        return cls(
            trace=ServiceTrace.from_dict(d["trace"]),
            cache_stats=dict(d.get("cache_stats", {})),
            plan_wall_s={k: list(v)
                         for k, v in d.get("plan_wall_s", {}).items()},
            total_time_s=float(d.get("total_time_s", 0.0)),
            # absent on payloads written without metrics: default to empty
            metrics=dict(d.get("metrics", {})),
        )

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ServiceReport":
        return cls.from_dict(json.loads(s))

    # stitched job-level Gantt ---------------------------------------- #
    def gantt(self, width: int = 64) -> str:
        """ASCII job timeline: ``·`` queued, ``█`` running, ``✕``
        infeasible end; a header row marks platform events ``▼``.

        One row per admitted job (rejected submissions are listed
        below the chart), stitched across replans — the job-level
        view of the whole multi-workflow run.
        """
        tr = self.trace
        horizon = tr.horizon if tr.horizon > 0 else 1.0
        scale = (width - 1) / horizon

        def col(t: float) -> int:
            return max(0, min(width - 1, int(t * scale)))

        lines = []
        marks = [" "] * width
        for e in tr.events:
            marks[col(float(e["time"]))] = "▼"
        label_w = max([12] + [len(f"{j.name}#{j.job_id}")
                              for j in tr.jobs])
        lines.append(f"{'':{label_w}}  |{''.join(marks)}|  t_max="
                     f"{tr.horizon:.1f}")
        for j in tr.jobs:
            if j.status == "rejected":
                continue
            row = [" "] * width
            start = col(j.arrival_t)
            end_t = (j.finish_t if j.finish_t is not None
                     else tr.horizon)
            disp = col(j.dispatch_t if j.dispatch_t is not None
                       else end_t)
            for c in range(start, disp):
                row[c] = "·"
            for c in range(disp, col(end_t) + 1):
                row[c] = "█"
            if j.status == "infeasible":
                row[col(end_t)] = "✕"
            tag = f"{j.name}#{j.job_id}"
            suffix = (f"  [{j.tenant}] {j.status}"
                      + (f" ({j.planning_path})"
                         if j.planning_path else ""))
            lines.append(f"{tag:{label_w}}  |{''.join(row)}|{suffix}")
        for j in tr.jobs:
            if j.status == "rejected":
                code = (j.rejection or {}).get("code", "?")
                lines.append(
                    f"{j.name}#{j.job_id}: rejected [{code}] "
                    f"at t={j.arrival_t:g}")
        return "\n".join(lines)
