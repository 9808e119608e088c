"""Sustained admission: an arrival stream of one fingerprinted workflow.

:func:`run_sustained` is the service-level face of
:mod:`repro_torch.throughput`: it admits ``n_instances`` repeat arrivals of
the *same* workflow, plans once through the plan cache (a fingerprint
hit replays the cached partition through the ``throughput_seeded``
pipeline — no k' sweep; a miss runs the full rate-maximizing sweep of
:func:`~repro_torch.throughput.plan.plan_throughput` and stores the winner),
replicates the mapping onto idle processors, and replays the whole
stream in one pipelined engine pass.  The outcome is an ordinary
:class:`~repro_torch.service.report.ServiceReport`: one completed
:class:`~repro_torch.service.report.JobRecord` per instance, achieved
instances/s and the analytic saturation rate as gauges, and the
per-instance latency distribution as a histogram — so p50/p99 come off
the same :mod:`repro_torch.obs.metrics` machinery every other report uses
(``report.instance_latency_percentiles``).

Determinism matches the rest of the service: arrival instants are
seeded (:class:`~repro_torch.throughput.arrivals.ArrivalSpec`), the engine is
virtual-time, and the trace is bit-identical run to run.  At rate→0
(one instance) the pipelined replay reproduces ``schedule(wf, platform,
simulate=True)`` bit-exactly — the same identity anchor the event loop
holds.
"""
from __future__ import annotations

import time

from repro_torch.core import counters
from repro_torch.core.dag import Workflow
from repro_torch.core.platform import Platform
from repro_torch.core.scheduler import (
    PIPELINES,
    Scheduler,
    SchedulerConfig,
)
from repro_torch.obs.metrics import METRICS

from .fingerprint import fingerprint_workflow
from .plancache import PlanCache
from .report import JobRecord, ServiceReport, ServiceTrace

__all__ = ["run_sustained"]


def _throughput_opts(latency_bound, max_replicas, include_comm) -> dict:
    opts = {"include_comm": include_comm}
    if latency_bound is not None:
        opts["latency_bound"] = latency_bound
    if max_replicas is not None:
        opts["max_replicas"] = max_replicas
    return opts


def run_sustained(
    workflow: Workflow,
    platform: Platform,
    *,
    rate: float,
    n_instances: int = 32,
    arrival_kind: str = "poisson",
    seed: int = 0,
    latency_bound: float | None = None,
    max_replicas: int | None = None,
    include_comm: bool = True,
    comm: str = "contention-free",
    config: SchedulerConfig | None = None,
    cache: PlanCache | None = None,
    name: str = "sustained",
    **overrides,
) -> ServiceReport:
    """Admit a sustained arrival stream of ``workflow`` at ``rate``.

    Plans through ``cache`` when given (fingerprint hit → seeded
    throughput pipeline, miss → full rate-maximizing k' sweep, winner
    stored), replicates onto idle processors, replays ``n_instances``
    seeded arrivals in one pipelined simulation with summed memory
    occupancy, and lands everything on a
    :class:`~repro_torch.service.report.ServiceReport`:

    * one completed :class:`JobRecord` per instance (arrival /
      dispatch / finish in virtual time, the replica group's processor
      names as the allocation);
    * ``sustained_instance_latency`` histogram →
      ``report.instance_latency_percentiles``;
    * gauges ``sustained_instances_per_s`` (achieved),
      ``sustained_offered_rate``, ``sustained_saturation_rate`` (the
      plan's analytic sustainable rate — offers beyond it saturate);
    * the live :class:`~repro_torch.throughput.pipeline.PipelinedReport` as
      ``report.pipelined`` (memory-occupancy trace included).

    An unplannable workflow (or a ``latency_bound`` no k' meets) is a
    structured outcome: a report whose single job is ``infeasible``.
    Extra ``overrides`` (``kprime``, ``workers``, ...) are
    :class:`~repro_torch.core.scheduler.SchedulerConfig` material for the
    cold planning path; a cache hit skips the sweep they shape.
    """
    from repro_torch.throughput import ArrivalSpec, plan_throughput, \
        simulate_pipelined

    t_wall = time.perf_counter()
    msnap = METRICS.snapshot()
    csnap = msnap["counters"]
    plan_wall: dict[str, list[float]] = {}
    log: list[dict] = []
    opts = _throughput_opts(latency_bound, max_replicas, include_comm)
    cfg = config if config is not None else SchedulerConfig()

    fp = fingerprint_workflow(workflow)
    key = PlanCache.key(fp, platform) if cache is not None else None

    best = plan = k_prime = None
    infeasibility = None
    path = "cold"
    if cache is not None:
        cached = cache.get(key)
        if cached is not None:
            t0 = time.perf_counter()
            rep = Scheduler(
                cfg, stages=PIPELINES["throughput_seeded"],
                throughput_options=opts,
            ).seeded(workflow, platform, cached.block_of_task,
                     k_prime=cached.k_prime)
            dt = time.perf_counter() - t0
            plan_wall.setdefault("seeded", []).append(dt)
            METRICS.observe("service_plan_latency_s", dt)
            if rep.feasible:
                best = rep.best
                plan = best.extras.get("throughput")
                k_prime = cached.k_prime
                path = "seeded"
            else:
                counters.bump("service_seed_fallbacks")
    if plan is None:
        t0 = time.perf_counter()
        tr = plan_throughput(
            workflow, platform, latency_bound=latency_bound,
            max_replicas=max_replicas, include_comm=include_comm,
            config=cfg, **overrides)
        dt = time.perf_counter() - t0
        plan_wall.setdefault("cold", []).append(dt)
        METRICS.observe("service_plan_latency_s", dt)
        path = "cold"
        if tr.feasible:
            best, plan, k_prime = tr.best, tr.plan, tr.k_prime
            if cache is not None:
                cache.put(key, best.block_of_task(), k_prime,
                          best.makespan)
        else:
            infeasibility = tr.report.infeasibility

    jobs: list[JobRecord] = []
    horizon = 0.0
    busy = 0.0
    pipelined = None
    if plan is None:
        log.append({"t": 0.0, "kind": "infeasible",
                    "reason": (infeasibility.reason
                               if infeasibility is not None else "?")})
        jobs.append(JobRecord(
            job_id=0, name=name, tenant="stream", arrival_t=0.0,
            status="infeasible", n_tasks=workflow.n,
            fingerprint=fp.digest,
            infeasibility=(infeasibility.to_dict()
                           if infeasibility is not None else None),
        ))
    else:
        spec = ArrivalSpec(float(rate), arrival_kind)
        pipelined = simulate_pipelined(
            best, platform, arrivals=spec.times(n_instances, seed),
            plan=plan, comm=comm, memory=True)
        horizon = pipelined.horizon
        busy = sum(
            pipelined.block_finish[v] - pipelined.block_start[v]
            for v in pipelined.block_start)
        log.append({
            "t": 0.0, "kind": "plan", "path": path, "k_prime": k_prime,
            "replicas": plan.n_replicas, "plan_rate": plan.rate,
            "period": plan.period,
        })
        group_names = [
            sorted(platform.procs[r].name for r in g.procs)
            for g in plan.groups
        ]
        for rec in pipelined.instances:
            METRICS.observe("sustained_instance_latency", rec.latency)
            jobs.append(JobRecord(
                job_id=rec.instance, name=f"{name}#{rec.instance}",
                tenant="stream", arrival_t=rec.arrival,
                status="completed", n_tasks=workflow.n,
                fingerprint=fp.digest, dispatch_t=rec.start,
                finish_t=rec.finish,
                queue_wait=rec.start - rec.arrival,
                latency=rec.latency,
                makespan=rec.finish - rec.start,
                planning_path=path, k_prime=k_prime,
                allocation=list(group_names[rec.replica]),
            ))
            log.append({"t": rec.arrival, "kind": "instance",
                        "instance": rec.instance,
                        "group": rec.replica})
        if not pipelined.memory.feasible:
            for viol in pipelined.memory.violations:
                log.append({
                    "t": viol.time, "kind": "memory_violation",
                    "proc": viol.proc, "instance": viol.instance,
                    "occupancy": viol.occupancy,
                    "capacity": viol.capacity,
                })
        gauges = {
            "sustained_instances_per_s": pipelined.achieved_rate,
            "sustained_offered_rate": float(rate),
            "sustained_saturation_rate": plan.rate,
            "sustained_replicas": float(plan.n_replicas),
        }
        for g, v in gauges.items():
            METRICS.gauge(g, v)

    cache_stats = counters.delta(csnap)
    if cache is not None:
        cache_stats["service_plan_cache_size"] = len(cache)
    mdelta = METRICS.delta(msnap)
    mdelta.pop("counters", None)
    if plan is not None:
        # METRICS.delta drops gauges whose value matches the opening
        # snapshot — a repeat run landing on the identical achieved
        # rate would silently lose them, so pin this run's gauges.
        mdelta.setdefault("gauges", {}).update(gauges)
    trace = ServiceTrace(
        name=name,
        platform_name=platform.name,
        n_procs=platform.k,
        jobs=jobs,
        events=[],
        log=log,
        utilization=[],
        horizon=horizon,
        busy_proc_time=busy,
    )
    return ServiceReport(
        trace=trace,
        cache_stats=cache_stats,
        plan_wall_s={k: list(v) for k, v in sorted(plan_wall.items())},
        total_time_s=time.perf_counter() - t_wall,
        metrics=mdelta,
        pipelined=pipelined,
    )
