"""The service event loop: continuous multi-workflow operation.

One deterministic **virtual-time** queue drives everything: workflow
submissions, job completions and :class:`PlatformEvent` groups are
heap-ordered by ``(time, priority, push-sequence)`` with platform
events first (capacity changes are visible before anything else at the
same instant), completions second (freed processors are visible to
same-instant submissions) and submissions last.  Processing an item
never consults a wall clock, so the same submission trace yields a
bit-identical :class:`~repro_torch.service.report.ServiceTrace` — including
under ``workers > 1`` (the parallel k' sweep is bit-identical by
construction).

Job lifecycle::

    submitted ── admit ──> queued ── dispatch ──> running ── complete
        │ (validation /         │ (weighted fair     │  ▲
        │  quota violation)     │  share; deferral   │  └ event →
        ▼                       │  is transient)     │    pause/freeze/
    rejected                    ▼                    ▼    warm replan
                           infeasible ◀────── displaced (requeued)

Co-scheduling: a dispatched job *owns* exactly the processors its
mapping uses; everything else stays free for the next job in fair
order.  Ownership is tracked in global indices, while each job plans
and executes in its own carved sub-platform's coordinates — the
``to_global`` map ties them together across events (which compact
global indices).  When an event touches a job's processors, the job is
paused at the event instant (:func:`repro_torch.scenario.freeze_prefix` on
its own sub-platform — the scenario runner's checkpoint machinery), its durable
prefix is frozen, and the residual warm-starts on the surviving owned
processors via :meth:`Scheduler.resume`; if the warm path fails, a
cold replan on survivors-plus-free capacity; if even that fails with
other jobs still running, the job is *displaced* back into the queue
(its residual re-fingerprinted, retried as capacity frees); only a job
that cannot be planned with the whole platform free is terminally
infeasible — structured, never an exception.

Planning goes through the plan cache: a fingerprint hit seeds the
partition (:meth:`Scheduler.seeded` — no k' sweep), a miss plans cold
and stores the winner.  The identity anchor: one submission at t=0, no
events, empty quotas reproduces ``schedule(wf, platform,
simulate=True)`` bit-exactly — the cold path *is* that call.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field, replace
from heapq import heappop, heappush
from typing import Sequence

from repro_torch.core import counters
from repro_torch.core.dag import Workflow
from repro_torch.core.platform import Platform
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.workflows import WorkflowValidationError
from repro_torch.obs import (
    JsonlSink,
    ObsConfig,
    service_virtual_events,
    span_events,
    write_chrome_trace,
)
from repro_torch.obs import tracer as _trc
from repro_torch.obs.metrics import METRICS, RATIO_BOUNDARIES
from repro_torch.obs.tracer import trace_span
from repro_torch.scenario import (
    LinkDegrade,
    PlatformEvent,
    ProcArrival,
    ProcFailure,
    SpeedChange,
    freeze_prefix,
    validate_event_timeline,
)

from .admission import FairQueue, QuotaConfig
from .fingerprint import fingerprint_workflow, platform_signature
from .plancache import PlanCache
from .report import JobRecord, ServiceReport, ServiceTrace
from .submission import Rejection, Submission, resolve_workflow

__all__ = ["ServiceConfig", "WorkflowService", "run_service"]

_PRIO_EVENT = 0
_PRIO_COMPLETE = 1
_PRIO_SUBMIT = 2


@dataclass
class ServiceConfig:
    """Knobs for one service run.

    ``scheduler`` drives every planning call (cold, seeded, warm —
    ``simulate`` is forced on internally: execution *is* the
    simulation).  ``plan_cache=False`` disables fingerprint seeding;
    ``cache_capacity`` bounds the LRU.  Quotas default to the empty
    config (admit everything, plain FIFO fairness).  ``obs`` is the
    run's :class:`~repro_torch.obs.ObsConfig`: ``enabled`` traces the event
    loop (submission → admission → dispatch → replan → completion,
    with the scheduler's own spans nested under each planning call),
    ``sink`` streams the service log + spans as JSONL, ``trace_path``
    writes a Chrome trace at the end of the run that unifies the
    wall-clock span tracks with the virtual-time job/utilization
    tracks (separate clock-domain ``pid``\\ s).  All of it is inert:
    the :class:`ServiceTrace` is bit-identical with ``obs`` on or off.
    """

    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    quotas: QuotaConfig = field(default_factory=QuotaConfig)
    plan_cache: bool = True
    cache_capacity: int = 128
    name: str = "service"
    obs: ObsConfig | None = None


class _Job:
    """Internal mutable job state (the public view is JobRecord)."""

    def __init__(self, seq: int, sub: Submission) -> None:
        self.seq = seq
        self.sub = sub
        self.name = sub.name
        self.tenant = sub.tenant
        self.arrival_t = sub.arrival_t
        self.deadline = sub.deadline
        self.status = "submitted"
        self.wf: Workflow | None = None       # current (residual) DAG
        self.n_tasks: int | None = None       # as admitted
        self.fp = None                        # fingerprint of self.wf
        self.dispatch_t: float | None = None
        self.finish_t: float | None = None
        self.planning_path: str | None = None
        self.k_prime: int | None = None
        self.n_replans = 0
        self.n_deferrals = 0
        self.gen = 0                          # completion generation
        self.platform: Platform | None = None  # carved planning frame
        self.to_global: list[int | None] = []  # carve idx -> global idx
        self.allocation: set[int] = set()      # owned global indices
        self.alloc_names: list[str] = []
        self.mapping = None                    # MappingResult (live)
        self.sim = None                        # SimReport of the segment
        self.summary = None                    # MappingSummary (last plan)
        self.t_seg = 0.0                       # segment start (virtual)
        self.rejection: Rejection | None = None
        self.infeasibility = None
        self._skip_sig: str | None = None      # last infeasible carve sig
        self._last_defer: tuple | None = None


class WorkflowService:
    """Deterministic virtual-time scheduler-as-a-service.

    Build one with the submission trace, the shared platform and the
    (time-sorted) platform-event timeline, then :meth:`run` it to a
    :class:`~repro_torch.service.report.ServiceReport`.  Pass a
    :class:`~repro_torch.service.plancache.PlanCache` to share cached plans
    across runs (e.g. warm-vs-cold benchmarking); by default each run
    gets a fresh cache.
    """

    def __init__(
        self,
        submissions: Sequence[Submission],
        platform: Platform,
        events: Sequence[PlatformEvent] = (),
        config: ServiceConfig | None = None,
        cache: PlanCache | None = None,
    ) -> None:
        self.config = config if config is not None else ServiceConfig()
        validate_event_timeline(tuple(events))
        self.events = tuple(events)
        self.platform = platform
        self._home_platform = platform
        self.jobs: list[_Job] = [
            _Job(i, s) for i, s in enumerate(
                sorted(submissions, key=lambda s: s.arrival_t))
        ]
        self.cache = cache if cache is not None else (
            PlanCache(self.config.cache_capacity)
            if self.config.plan_cache else None)
        self.queue = FairQueue(self.config.quotas)
        self._running: list[_Job] = []
        self._heap: list = []
        self._push_ctr = itertools.count()
        self._log: list[dict] = []
        self._event_dicts: list[dict] = []
        self._util: list[list] = []
        self._busy_time = 0.0
        self._last_t = 0.0
        self._last_busy = 0
        self._horizon = 0.0
        self._plan_wall: dict[str, list[float]] = {}
        self._sched_cfg = replace(self.config.scheduler, simulate=True)
        self._sink = JsonlSink(None)  # run() opens the real one

    # ---------------------------------------------------------------- #
    # bookkeeping helpers
    # ---------------------------------------------------------------- #
    def _note(self, entry: dict) -> None:
        """Append to the deterministic service log and stream the same
        entry to the JSONL sink (no-op sink when obs is off)."""
        self._log.append(entry)
        self._sink.emit({"event": "service", **entry})

    def _push(self, t: float, prio: int, kind: str, payload) -> None:
        heappush(self._heap, (t, prio, next(self._push_ctr), kind,
                              payload))

    def _free(self) -> list[int]:
        busy: set[int] = set()
        for job in self._running:
            busy |= job.allocation
        return [j for j in range(self.platform.k) if j not in busy]

    def _advance(self, t: float) -> None:
        if t > self._last_t:
            self._busy_time += (t - self._last_t) * self._last_busy
            self._last_t = t
        self._horizon = max(self._horizon, t)

    def _note_util(self, t: float) -> None:
        self._advance(t)
        busy = sum(len(j.allocation) for j in self._running)
        k = self.platform.k
        if (not self._util or self._util[-1][1] != busy
                or self._util[-1][2] != k):
            if self._util and self._util[-1][0] == t:
                self._util[-1] = [t, busy, k]
            else:
                self._util.append([t, busy, k])
        self._last_busy = busy

    def _comm(self):
        return (self._sched_cfg.sim_options or {}).get(
            "comm", "contention-free")

    def _carve(self, procs: list[int]) -> tuple[Platform, list[int]]:
        """Sub-platform over global indices ``procs`` (sorted).  The
        full set returns the platform object itself — ``without``
        would rename it, and the single-job anchor must plan on the
        *identical* platform ``schedule()`` would see."""
        procs = sorted(procs)
        if len(procs) == self.platform.k:
            return self.platform, list(range(self.platform.k))
        drop = set(range(self.platform.k)) - set(procs)
        return self.platform.without(drop), procs

    # ---------------------------------------------------------------- #
    # admission
    # ---------------------------------------------------------------- #
    def _reject(self, job: _Job, t: float, code: str,
                reason: str) -> None:
        job.status = "rejected"
        job.finish_t = t
        job.rejection = Rejection(time=t, job_id=job.seq, name=job.name,
                                  tenant=job.tenant, code=code,
                                  reason=reason)
        counters.bump("service_rejections")
        self._note({"t": t, "kind": "reject", "job": job.seq,
                          "code": code, "reason": reason})

    def _admit(self, job: _Job, t: float) -> None:
        with trace_span("service.admit", job=job.seq, t=t):
            self._admit_impl(job, t)

    def _admit_impl(self, job: _Job, t: float) -> None:
        try:
            wf = resolve_workflow(job.sub)
        except WorkflowValidationError as exc:
            self._reject(job, t, "malformed", str(exc))
            return
        quota = self.config.quotas.quota(job.tenant)
        if quota.max_tasks is not None and wf.n > quota.max_tasks:
            self._reject(
                job, t, "size-quota",
                f"{wf.n} tasks exceeds tenant cap {quota.max_tasks}")
            return
        if (quota.max_pending is not None
                and self.queue.pending(job.tenant) >= quota.max_pending):
            self._reject(
                job, t, "queue-quota",
                f"tenant already has {self.queue.pending(job.tenant)} "
                f"pending job(s) (cap {quota.max_pending})")
            return
        job.wf = wf
        job.n_tasks = wf.n
        job.fp = fingerprint_workflow(wf)
        job.status = "queued"
        self.queue.push(job)
        counters.bump("service_admissions")
        self._note({"t": t, "kind": "admit", "job": job.seq,
                          "tenant": job.tenant, "n_tasks": wf.n,
                          "fingerprint": job.fp.digest[:12]})

    # ---------------------------------------------------------------- #
    # planning (plan cache in front of the scheduler)
    # ---------------------------------------------------------------- #
    def _wall(self, path: str, t0: float) -> None:
        """Record one planning call's wall clock under ``path`` and in
        the ``service_plan_latency_s`` histogram (p50/p95/p99 on the
        report derive from it)."""
        dt = time.perf_counter() - t0
        self._plan_wall.setdefault(path, []).append(dt)
        METRICS.observe("service_plan_latency_s", dt)

    def _plan(self, job: _Job, sub_plat: Platform):
        """Returns ``(report, path)`` with ``path`` in
        {"seeded", "cold"}; wall clocks land in ``plan_wall_s``."""
        tr = _trc.current_tracer()
        if tr is None:
            return self._plan_impl(job, sub_plat)
        snap = counters.snapshot()
        with tr.span("service.plan", job=job.seq,
                     n_tasks=job.wf.n) as sp:
            rep, path = self._plan_impl(job, sub_plat)
            # the span carries the planning call's counter deltas
            sp.attrs.update(counters.delta(snap))
            sp.attrs["path"] = path
            sp.attrs["feasible"] = rep.feasible
        return rep, path

    def _plan_impl(self, job: _Job, sub_plat: Platform):
        sch = Scheduler(self._sched_cfg)
        key = None
        if self.cache is not None:
            key = PlanCache.key(job.fp, sub_plat)
            cached = self.cache.get(key)
            if cached is not None:
                t0 = time.perf_counter()
                rep = sch.seeded(job.wf, sub_plat,
                                 cached.block_of_task,
                                 k_prime=cached.k_prime)
                self._wall("seeded", t0)
                if rep.feasible:
                    if cached.makespan:
                        # premium the seeded plan pays over its cached
                        # winner (≈1.0 when the seed held up)
                        METRICS.observe(
                            "service_makespan_premium",
                            rep.summary.makespan / cached.makespan,
                            boundaries=RATIO_BOUNDARIES)
                    return rep, "seeded"
                counters.bump("service_seed_fallbacks")
        t0 = time.perf_counter()
        rep = sch.schedule(job.wf, sub_plat)
        self._wall("cold", t0)
        if rep.feasible and key is not None:
            self.cache.put(key, rep.summary.block_of_task,
                           rep.summary.k_prime, rep.summary.makespan)
        return rep, "cold"

    # ---------------------------------------------------------------- #
    # dispatch
    # ---------------------------------------------------------------- #
    def _running_count(self, tenant: str) -> int:
        return sum(1 for j in self._running if j.tenant == tenant)

    def _defer(self, job: _Job, t: float, code: str,
               reason: str) -> None:
        key = (code, reason)
        if job._last_defer == key:
            return  # same verdict as last attempt: don't re-log
        job._last_defer = key
        job.n_deferrals += 1
        counters.bump("service_deferrals")
        self._note({"t": t, "kind": "defer", "job": job.seq,
                          "code": code, "reason": reason})

    def _fail(self, job: _Job, t: float, infeas) -> None:
        if job.status == "queued":
            self.queue.remove(job)
        elif job in self._running:
            self._running.remove(job)
        job.status = "infeasible"
        job.finish_t = t
        job.infeasibility = infeas
        job.allocation = set()
        counters.bump("service_infeasible")
        self._note({"t": t, "kind": "infeasible", "job": job.seq,
                          "stage": infeas.stage, "reason": infeas.reason})
        self._note_util(t)

    def _start(self, job: _Job, rep, path: str, t: float,
               sub_plat: Platform, to_global: list[int]) -> None:
        res, sim = rep.best, rep.sim
        q = res.quotient
        used = sorted({q.proc[v] for v in q.members})
        job.platform = sub_plat
        job.to_global = list(to_global)
        job.allocation = {to_global[pj] for pj in used}
        job.alloc_names = sorted(
            self.platform.procs[g].name for g in job.allocation)
        job.mapping = res
        job.sim = sim
        job.summary = rep.summary
        job.status = "running"
        if job.dispatch_t is None:        # displaced jobs keep the first
            job.dispatch_t = t
            job.planning_path = path
            job.k_prime = rep.summary.k_prime
            # virtual-time wait from arrival to first dispatch
            METRICS.observe("service_queue_wait", t - job.arrival_t)
        job.t_seg = t
        job.gen += 1
        job._skip_sig = None
        job._last_defer = None
        self.queue.remove(job)
        self.queue.charge(job.tenant, job.wf.total_work())
        self._running.append(job)
        self._push(t + sim.makespan, _PRIO_COMPLETE, "complete",
                   (job, job.gen))
        counters.bump("service_dispatches")
        self._note({
            "t": t, "kind": "dispatch", "job": job.seq, "path": path,
            "procs": len(job.allocation), "makespan": sim.makespan,
        })
        self._note_util(t)

    def _dispatch(self, t: float) -> None:
        with trace_span("service.dispatch", t=t):
            self._dispatch_impl(t)

    def _dispatch_impl(self, t: float) -> None:
        while True:
            free = self._free()
            if not free or not len(self.queue):
                return
            placed = False
            for job in self.queue.fair_order():
                quota = self.config.quotas.quota(job.tenant)
                if (quota.max_running is not None
                        and self._running_count(job.tenant)
                        >= quota.max_running):
                    self._defer(
                        job, t, "running-quota",
                        f"tenant at max_running={quota.max_running}")
                    continue
                sub_plat, to_global = self._carve(free)
                sig = platform_signature(sub_plat)
                if job._skip_sig == sig:
                    continue  # same capacity already proved infeasible
                rep, path = self._plan(job, sub_plat)
                if rep.feasible:
                    self._start(job, rep, path, t, sub_plat, to_global)
                    placed = True
                    break  # capacity + fair order changed: new round
                if self._running or len(free) < self.platform.k:
                    job._skip_sig = sig
                    self._defer(job, t, "capacity",
                                rep.infeasibility.reason)
                else:
                    # the whole platform was free and it still failed:
                    # no future capacity can be larger (arrivals reset
                    # _skip_sig via the new signature anyway)
                    self._fail(job, t, rep.infeasibility)
                    placed = True
                    break
            if not placed:
                return

    # ---------------------------------------------------------------- #
    # platform events
    # ---------------------------------------------------------------- #
    def _affected(self, ev: PlatformEvent,
                  alloc_cur: dict[_Job, set[int]]) -> set[_Job]:
        if isinstance(ev, ProcFailure):
            return {job for job, ac in alloc_cur.items()
                    if ac & ev.procs}
        if isinstance(ev, SpeedChange):
            return {job for job, ac in alloc_cur.items()
                    if ev.proc in ac}
        if isinstance(ev, LinkDegrade):
            return {job for job, ac in alloc_cur.items()
                    if ev.src in ac and ev.dst in ac}
        if isinstance(ev, ProcArrival):
            return set()  # new capacity disturbs nobody's plan
        # unknown event kind: conservatively replan everyone running
        return set(alloc_cur)

    def _on_events(self, group: Sequence[PlatformEvent],
                   t: float) -> None:
        cur = self.platform
        cmap: dict[int, int | None] = {j: j for j in range(cur.k)}
        affected: set[_Job] = set()
        for ev in group:
            alloc_cur = {
                job: {cmap[g] for g in job.allocation
                      if cmap[g] is not None}
                for job in self._running
            }
            affected |= self._affected(ev, alloc_cur)
            cur, m = ev.apply(cur)
            cmap = {j: (m[c] if c is not None else None)
                    for j, c in cmap.items()}
            self._event_dicts.append(ev.to_dict())
            self._note({"t": t, "kind": "event",
                              "event": ev.kind,
                              "detail": ev.describe()})
        self.platform = cur
        for job in self._running:
            job.allocation = {cmap[g] for g in job.allocation
                              if cmap[g] is not None}
            job.to_global = [
                cmap[g] if (g is not None and cmap[g] is not None)
                else None
                for g in job.to_global
            ]
        for job in sorted(affected, key=lambda j: j.seq):
            self._replan_job(job, t)
        self._note_util(t)
        self._dispatch(t)

    def _requeue(self, job: _Job, t: float, residual: Workflow) -> None:
        """Displace: back to the queue with the residual workflow."""
        job.status = "queued"
        job.wf = residual
        job.fp = fingerprint_workflow(residual)
        job.mapping = job.sim = None
        job.allocation = set()
        job.platform = None
        job.to_global = []
        job._skip_sig = None
        job._last_defer = None
        self.queue.push(job)
        counters.bump("service_displacements")
        self._note({"t": t, "kind": "displaced", "job": job.seq,
                          "residual_tasks": residual.n})

    def _adopt(self, job: _Job, rep, t: float, path: str) -> None:
        """Install a feasible replan as the job's new segment."""
        res, sim = rep.best, rep.sim
        q = res.quotient
        used = sorted({q.proc[v] for v in q.members})
        job.mapping = res
        job.sim = sim
        job.summary = rep.summary
        job.allocation = {job.to_global[pj] for pj in used}
        job.alloc_names = sorted(
            self.platform.procs[g].name for g in job.allocation)
        job.t_seg = t
        job.gen += 1
        self._push(t + sim.makespan, _PRIO_COMPLETE, "complete",
                   (job, job.gen))
        entry = {
            "t": t, "kind": "replan", "job": job.seq, "path": path,
            "procs": len(job.allocation),
            "residual_tasks": job.wf.n,
            "remaining_makespan": sim.makespan,
        }
        ckpt = getattr(job, "_checkpoint_decisions", None)
        if ckpt:
            entry["checkpoint_priced"] = len(ckpt)
            entry["checkpoint_migrate_wins"] = sum(
                1 for c in ckpt if c["decision"] == "migrate")
        self._note(entry)

    def _replan_job(self, job: _Job, t: float) -> None:
        tr = _trc.current_tracer()
        if tr is None:
            return self._replan_job_impl(job, t)
        snap = counters.snapshot()
        with tr.span("service.replan", job=job.seq, t=t) as sp:
            self._replan_job_impl(job, t)
            sp.attrs.update(counters.delta(snap))
            sp.attrs["status"] = job.status

    def _replan_job_impl(self, job: _Job, t: float) -> None:
        rel = t - job.t_seg
        if rel >= job.sim.horizon:
            return  # segment already (durably) done; completion stands
        counters.bump("service_replans")
        job.n_replans += 1
        old_carve, to_global = job.platform, job.to_global
        # carve procs still owned by this job after the event remap
        surv = [cj for cj in range(old_carve.k)
                if to_global[cj] is not None
                and to_global[cj] in job.allocation]
        if surv:
            # re-carve from the *current* global platform so the warm
            # start sees post-event speeds/links, not the stale copies
            # held by the old carve (the pause itself, below, runs on
            # the old carve: the prefix executed under the old state)
            new_carve, new_to_global = self._carve(
                [to_global[cj] for cj in surv])
            pos = {g: i for i, g in enumerate(new_to_global)}
            carve_map = {
                cj: (pos[to_global[cj]] if cj in set(surv) else None)
                for cj in range(old_carve.k)}
        else:
            new_carve, new_to_global = Platform(
                [], self.platform.bandwidth,
                f"{old_carve.name}-degraded"), []
            carve_map = {cj: None for cj in range(old_carve.k)}
        fz = freeze_prefix(job.wf, job.mapping, old_carve, rel,
                           new_carve, carve_map, comm=self._comm())
        # restart-vs-migrate pricing for the replan log entry
        job._checkpoint_decisions = fz.checkpoint_decisions
        if fz.state.wf.n == 0:
            return  # nothing left to run; completion event stands
        warm = None
        if surv:
            t0 = time.perf_counter()
            warm = Scheduler(self._sched_cfg).resume(fz.state)
            self._wall("replan", t0)
        if warm is not None and warm.feasible:
            job.wf = fz.state.wf
            job.platform = new_carve
            job.to_global = list(new_to_global)
            self._adopt(job, warm, t, "warm")
            return
        # warm path gone (all procs lost, or residual no longer fits):
        # cold replan on surviving owned + currently free capacity
        counters.bump("service_replan_cold_fallbacks")
        cand = sorted(set(job.allocation) | set(self._free()))
        if cand:
            plat2, to_g2 = self._carve(cand)
            t0 = time.perf_counter()
            cold = Scheduler(self._sched_cfg).schedule(fz.state.wf,
                                                      plat2)
            self._wall("replan", t0)
            if cold.feasible:
                job.wf = fz.state.wf
                job.platform = plat2
                job.to_global = list(to_g2)
                self._adopt(job, cold, t, "cold")
                return
            if len(cand) == self.platform.k:
                # had the whole platform and still failed: terminal
                self._fail(job, t, cold.infeasibility)
                return
        # capacity is tied up elsewhere: displace, retry as it frees
        self._running.remove(job)
        self._requeue(job, t, fz.state.wf)
        self._note_util(t)

    # ---------------------------------------------------------------- #
    # completion
    # ---------------------------------------------------------------- #
    def _on_complete(self, payload, t: float) -> None:
        job, gen = payload
        if job.status != "running" or gen != job.gen:
            return  # superseded by a replan or displacement
        with trace_span("service.complete", job=job.seq, t=t):
            self._complete_impl(job, t)

    def _complete_impl(self, job: _Job, t: float) -> None:
        job.status = "completed"
        job.finish_t = t
        self._running.remove(job)
        job.allocation = set()
        counters.bump("service_completions")
        self._note({"t": t, "kind": "complete", "job": job.seq,
                          "tenant": job.tenant})
        self._note_util(t)
        self._dispatch(t)

    # ---------------------------------------------------------------- #
    def _record(self, job: _Job) -> JobRecord:
        mapping = None
        if job.summary is not None and job.status == "completed":
            mapping = job.summary.to_dict()
            mapping["runtime_s"] = 0.0   # wall clock: not trace material
        queue_wait = latency = makespan = deadline_met = None
        if job.dispatch_t is not None:
            queue_wait = job.dispatch_t - job.arrival_t
        if job.finish_t is not None and job.status != "rejected":
            latency = job.finish_t - job.arrival_t
        if job.status == "completed":
            makespan = job.finish_t - job.dispatch_t
            if job.deadline is not None:
                deadline_met = job.finish_t <= job.deadline
        return JobRecord(
            job_id=job.seq, name=job.name, tenant=job.tenant,
            arrival_t=job.arrival_t, status=job.status,
            deadline=job.deadline, n_tasks=job.n_tasks,
            fingerprint=job.fp.digest if job.fp is not None else None,
            dispatch_t=job.dispatch_t, finish_t=job.finish_t,
            queue_wait=queue_wait, latency=latency, makespan=makespan,
            deadline_met=deadline_met,
            planning_path=job.planning_path, k_prime=job.k_prime,
            n_replans=job.n_replans, n_deferrals=job.n_deferrals,
            allocation=list(job.alloc_names),
            mapping=mapping,
            rejection=(job.rejection.to_dict()
                       if job.rejection is not None else None),
            infeasibility=(job.infeasibility.to_dict()
                           if job.infeasibility is not None else None),
        )

    def run(self) -> ServiceReport:
        """Drain the virtual-time queue; always a ServiceReport."""
        obs = self.config.obs
        tracer = obs.make_tracer() if obs is not None else None
        self._sink = JsonlSink(obs.sink if obs is not None else None)
        try:
            # activate(None) is a passthrough: an enclosing tracer (a
            # caller tracing across service runs) keeps collecting
            with _trc.activate(tracer):
                report = self._run_impl()
            if tracer is not None:
                for s in tracer.spans:
                    self._sink.emit({"event": "span", **s.to_dict()})
        finally:
            self._sink.close()
            self._sink = JsonlSink(None)
        if tracer is not None:
            report.spans = list(tracer.spans)
            if obs.trace_path is not None:
                # one file, two clock domains: wall-clock spans under
                # pid "wall", virtual-time job/util tracks under
                # pid "virtual"
                write_chrome_trace(
                    obs.trace_path,
                    span_events(tracer.spans)
                    + service_virtual_events(report.trace),
                    meta={"service": self.config.name})
        return report

    def _run_impl(self) -> ServiceReport:
        t_wall = time.perf_counter()
        msnap = METRICS.snapshot()
        snap = msnap["counters"]
        for job in self.jobs:
            self._push(job.arrival_t, _PRIO_SUBMIT, "submit", job)
        group: list[PlatformEvent] = []
        for ev in self.events:   # validated sorted; group equal times
            if group and group[0].time == ev.time:
                group.append(ev)
            else:
                if group:
                    self._push(group[0].time, _PRIO_EVENT, "events",
                               group)
                group = [ev]
        if group:
            self._push(group[0].time, _PRIO_EVENT, "events", group)

        while self._heap:
            t, _prio, _c, kind, payload = heappop(self._heap)
            self._advance(t)
            if kind == "events":
                self._on_events(payload, t)
            elif kind == "complete":
                self._on_complete(payload, t)
            else:
                self._admit(payload, t)
                self._dispatch(t)

        leftovers = [j.seq for j in self.jobs
                     if j.status not in ("completed", "infeasible",
                                         "rejected")]
        if leftovers:  # conservation invariant; should be unreachable
            raise RuntimeError(
                f"service loop drained with non-terminal job(s) "
                f"{leftovers}")

        cache_stats = counters.delta(snap)
        if self.cache is not None:
            cache_stats["service_plan_cache_size"] = len(self.cache)
        mdelta = METRICS.delta(msnap)
        mdelta.pop("counters", None)  # already surfaced as cache_stats
        trace = ServiceTrace(
            name=self.config.name,
            platform_name=self._home_platform.name,
            n_procs=self._home_platform.k,
            jobs=[self._record(j) for j in self.jobs],
            events=list(self._event_dicts),
            log=list(self._log),
            utilization=[list(u) for u in self._util],
            horizon=self._horizon,
            busy_proc_time=self._busy_time,
        )
        return ServiceReport(
            trace=trace,
            cache_stats=cache_stats,
            plan_wall_s={k: list(v)
                         for k, v in sorted(self._plan_wall.items())},
            total_time_s=time.perf_counter() - t_wall,
            metrics=mdelta,
        )


def run_service(
    submissions: Sequence[Submission],
    platform: Platform,
    events: Sequence[PlatformEvent] = (),
    config: ServiceConfig | None = None,
    *,
    cache: PlanCache | None = None,
    obs: ObsConfig | None = None,
) -> ServiceReport:
    """One-call convenience: build a :class:`WorkflowService`, run it.

    ``obs`` overrides ``config.obs`` (shortcut for tracing one run:
    ``run_service(subs, plat, obs=ObsConfig(enabled=True,
    trace_path="trace.json"))``).
    """
    if obs is not None:
        config = replace(config if config is not None
                         else ServiceConfig(), obs=obs)
    return WorkflowService(submissions, platform, events, config,
                           cache).run()
