"""Rate-maximizing planning over the scheduler's k' sweep.

The ``throughput`` pipeline attaches a
:class:`~repro_torch.throughput.replicate.ThroughputPlan` to every feasible
k' attempt and lands each attempt's sustainable rate as a
single-observation histogram in that sweep point's ``metrics`` block.
The scheduler's own best-result reduction still minimizes *makespan*
(one instance as fast as possible) — :func:`plan_throughput` instead
reads the per-point rate observations and selects the k' whose
replicated plan sustains the **highest instance rate**, re-running the
single winning k' when it differs from the makespan winner.  That is
the "replication count and k' sweep jointly" objective: a finer
partition may lose on latency yet free enough processors for an extra
replica group to win on throughput.

:func:`saturation_sweep` replays one plan against a ladder of offered
arrival rates (:func:`~repro_torch.throughput.pipeline.simulate_pipelined`)
and reports achieved rate + latency percentiles per rung — the curve
whose knee is the saturation point
``repro_torch.service.run_sustained`` reports.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.dag import Workflow
from repro_torch.core.platform import Platform

from .arrivals import ArrivalSpec
from .pipeline import simulate_pipelined
from .replicate import ThroughputPlan

__all__ = ["ThroughputResult", "plan_throughput", "saturation_sweep"]


@dataclass
class ThroughputResult:
    """What :func:`plan_throughput` returns — never ``None``.

    ``report`` is the full k'-sweep :class:`ScheduleReport` (makespans,
    per-point rates in ``sweep[i].metrics``); ``best`` / ``plan`` the
    rate-maximizing mapping and its replication (``None`` when no
    attempt was feasible — the report's ``infeasibility`` says why).
    """

    report: object
    best: object | None
    plan: ThroughputPlan | None
    k_prime: int | None

    @property
    def feasible(self) -> bool:
        return self.plan is not None

    @property
    def rate(self) -> float | None:
        return self.plan.rate if self.plan is not None else None

    @property
    def latency(self) -> float | None:
        return self.plan.latency if self.plan is not None else None


def _point_rate(point) -> float | None:
    """The attempt's observed sustainable rate, from its metrics block.

    Histogram deltas are always present for the bracket that observed
    them (unchanged gauges are elided from deltas), and the throughput
    stage observes exactly once per attempt — so the single
    observation's value is the histogram's ``sum``.
    """
    h = point.metrics.get("histograms", {}).get("throughput_rate")
    if not h or not h.get("count"):
        return None
    return float(h["sum"])


def plan_throughput(
    wf: Workflow,
    platform: Platform,
    *,
    latency_bound: float | None = None,
    max_replicas: int | None = None,
    include_comm: bool = True,
    config=None,
    **overrides,
) -> ThroughputResult:
    """Plan ``wf`` for sustained traffic: maximize instances/s.

    Runs the registered ``throughput`` pipeline across the k' sweep
    (``config`` / ``overrides`` are
    :class:`~repro_torch.core.scheduler.SchedulerConfig` material — ``kprime``,
    ``workers``, ``obs``, ...), then picks the attempt with the highest
    sustainable rate; ties prefer the smaller makespan, then the
    earlier sweep position.  ``latency_bound`` makes attempts whose
    *unreplicated* latency exceeds the bound structurally infeasible
    and stops replication at groups that would violate it.
    """
    from repro_torch.core.scheduler import Scheduler, SchedulerConfig

    cfg = config if config is not None else SchedulerConfig()
    opts = dict(cfg.throughput_options or {})
    opts.setdefault("include_comm", include_comm)
    if latency_bound is not None:
        opts["latency_bound"] = latency_bound
    if max_replicas is not None:
        opts["max_replicas"] = max_replicas
    run_overrides = {"algorithm": "throughput",
                     "throughput_options": opts, **overrides}
    report = Scheduler(cfg, **run_overrides).schedule(wf, platform)
    if report.best is None:
        return ThroughputResult(report=report, best=None, plan=None,
                                k_prime=None)

    best_kp: int | None = None
    best_rate = -math.inf
    best_ms = math.inf
    for p in report.sweep:
        if not p.feasible:
            continue
        r = _point_rate(p)
        if r is None:
            continue
        if r > best_rate or (r == best_rate and p.makespan < best_ms):
            best_kp, best_rate, best_ms = p.k_prime, r, p.makespan
    best = report.best
    if best_kp is not None and best_kp != best.extras.get("k_prime"):
        # the rate winner lost the makespan reduction: re-materialize
        # it with a single-point sweep (stages are deterministic, so
        # this reproduces the attempt exactly)
        rerun = Scheduler(cfg, **{**run_overrides, "kprime": [best_kp],
                                  "workers": 1}).schedule(wf, platform)
        if rerun.best is not None:
            best = rerun.best
    plan = best.extras.get("throughput")
    return ThroughputResult(report=report, best=best, plan=plan,
                            k_prime=best.extras.get("k_prime"))


def saturation_sweep(
    mapping,
    platform: Platform | None = None,
    *,
    rates,
    plan: ThroughputPlan | None = None,
    n_instances: int = 32,
    arrival_kind: str = "poisson",
    seed: int = 0,
    comm="contention-free",
) -> list[dict]:
    """Offered-rate ladder: one pipelined replay per rate.

    Returns one row per offered rate — ``{"offered", "achieved",
    "p50", "p99", "saturated"}`` — where ``saturated`` flags rungs
    whose achieved rate fell more than 5% short of the offer (the
    pipeline can no longer keep up; latencies grow without bound past
    this knee).  Memory tracking and event recording are off: this is
    the bulk path for a many-rung ladder.
    """
    rows = []
    for r in rates:
        rep = simulate_pipelined(
            mapping, platform,
            arrivals=ArrivalSpec(float(r), arrival_kind),
            n_instances=n_instances, seed=seed, plan=plan, comm=comm,
            memory=False, record_events=False)
        rows.append({
            "offered": float(r),
            "achieved": rep.achieved_rate,
            "p50": rep.percentile_latency(50),
            "p99": rep.percentile_latency(99),
            "saturated": rep.achieved_rate < 0.95 * float(r),
        })
    return rows
