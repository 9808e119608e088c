"""Execute a workflow through a timeline of platform events.

:func:`run_scenario` drives the full loop the paper's static story
stops short of: plan → execute (:mod:`repro_torch.sim`) → **pause** at the
next :class:`~repro_torch.scenario.events.PlatformEvent` → freeze the
executed prefix → extract the residual DAG → replan under the chosen
policy → repeat — then stitches the epochs into a
:class:`~repro_torch.scenario.report.TimelineReport`.

Execution semantics (the restart model):

* **output files are the unit of durability**: a block is *completed*
  once its compute interval ended **and** every outbound transfer has
  landed by the event (and, transitively, its whole quotient ancestry
  is completed) — only then do its tasks leave the workflow for good,
  never to be reassigned, and its boundary outputs count as
  materialized at their consumers (folded into task memory, not
  re-transferred);
* every other started block — mid-compute *or* with outputs still in
  transit — is *in flight*: its partial work is lost and it restarts
  in the next epoch (there is no checkpointing; pricing
  checkpoint-aware migration is a ROADMAP follow-on).  An in-flight
  transfer is never silently dropped: either its producer completes
  the durability rule or the producer re-executes and re-sends.
  :class:`~repro_torch.scenario.policies.PinnedWarmStart` pins in-flight
  blocks to their processor, so the restart at least never pays a
  migration;
* unstarted blocks carry over; whether they keep their assignment is
  the policy's call.

Identity anchor: with an empty event timeline the single segment *is*
``Scheduler(config).schedule(wf, platform)`` — same best makespan,
same simulated makespan, bit-exactly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.core.dag import Workflow
from repro_torch.core.platform import Platform
from repro_torch.core.scheduler import ResumeState, Scheduler, SchedulerConfig
from repro_torch.core.workflows import residual_workflow
from repro_torch.obs.tracer import trace_span
from repro_torch.sim import build_specs, resolve_comm, run_engine, simulate

from .events import PlatformEvent, validate_event_timeline
from .policies import resolve_policy
from .report import MigrationRecord, SegmentReport, TimelineReport

__all__ = ["FrozenPrefix", "Scenario", "apply_event_group",
           "freeze_prefix", "run_scenario"]


@dataclass
class Scenario:
    """A workflow, a platform, and what happens to the platform when.

    The event timeline must be **sorted by time** with finite,
    non-negative times — construction validates this and raises a
    structured :class:`~repro_torch.scenario.events.EventTimelineError`
    otherwise (the :mod:`repro_torch.service` event loop relies on the
    same invariant).  Execution pauses the simulation once per distinct
    event time (ties apply sequentially in listed order).  Processor
    indices in an event refer to the platform *as of that event's
    application*: after a ``ProcFailure``, later events (including
    same-instant ones) see the compacted indexing — compose through
    the ``proc_map`` each ``apply`` returns when building timelines
    programmatically.
    """

    workflow: Workflow
    platform: Platform
    events: Sequence[PlatformEvent] = ()
    name: str = ""

    def __post_init__(self) -> None:
        self.events = tuple(self.events)
        validate_event_timeline(self.events)
        if not self.name:
            self.name = f"{self.workflow.name}@{self.platform.name}"


def _frozen_blocks(trace, q) -> set[int]:
    """Blocks durably completed at the pause: compute finished, every
    outbound transfer landed, and (transitively) the same holds for
    the whole quotient ancestry — so the completed *task* set is
    closed under predecessors and no in-flight transfer is dropped."""
    done = {
        v for v in trace.finish
        if all((v, w) in trace.xfer_finish for w in q.succ[v])
    }
    # Fixpoint demotion: a delivered block below an undelivered
    # ancestor restarts too (rare: needs one producer transfer landed
    # and a sibling transfer still in flight).  Keeps closure exact.
    changed = True
    while changed:
        changed = False
        for v in sorted(done):
            if any(p not in done for p in q.pred[v]):
                done.discard(v)
                changed = True
    return done


def _event_groups(
    events: Sequence[PlatformEvent],
) -> list[list[PlatformEvent]]:
    """Events sorted by time, grouped per distinct time (one pause +
    one replan per group, however many events share the instant)."""
    ordered = sorted(events, key=lambda e: e.time)
    groups: list[list[PlatformEvent]] = []
    for e in ordered:
        if groups and groups[-1][0].time == e.time:
            groups[-1].append(e)
        else:
            groups.append([e])
    return groups


def apply_event_group(
    group: Sequence[PlatformEvent], platform: Platform,
) -> tuple[Platform, dict[int, int | None]]:
    """Apply same-instant events sequentially; return the new platform
    and the composed old-index → new-index map (``None`` = gone)."""
    new_platform = platform
    proc_map: dict[int, int | None] = {j: j for j in range(platform.k)}
    for ev in group:
        new_platform, m = ev.apply(new_platform)
        proc_map = {j: (m[pj] if pj is not None else None)
                    for j, pj in proc_map.items()}
    return new_platform, proc_map


@dataclass
class FrozenPrefix:
    """What :func:`freeze_prefix` extracted at a pause point.

    ``state`` is ready for :meth:`Scheduler.resume
    <repro_torch.core.scheduler.Scheduler.resume>`; ``sub_map`` maps each
    residual task index back to the paused workflow's task id;
    ``completed_local`` are the paused workflow's durably completed
    task ids; the remaining fields are restart accounting for
    migration records.
    """

    state: ResumeState
    sub_map: list[int]
    completed_local: set[int]
    completed_vids: set[int]
    inflight_vids: set[int]
    old_names: list[str]
    restarted_tasks: int
    restarted_blocks: int
    lost_work: float
    #: checkpoint-pricing decisions for the in-flight blocks (one dict
    #: per surviving started block: restart-in-place vs migrate its
    #: materialized inputs; ``applied`` says whether the verdict
    #: changed pinning) — lands on the MigrationRecord
    checkpoint_decisions: list[dict] = field(default_factory=list)


def freeze_prefix(
    wf: Workflow,
    mapping,
    platform: Platform,
    rel: float,
    new_platform: Platform,
    proc_map: dict[int, int | None],
    *,
    comm="contention-free",
    price_migration: bool = False,
) -> FrozenPrefix:
    """Pause ``mapping``'s execution on ``platform`` at ``rel`` (time
    since this plan started), freeze the durably completed prefix, and
    build the warm-start :class:`ResumeState` on ``new_platform``.

    This is the pause-replan-stitch core shared by
    :func:`run_scenario` (one workflow, platform timeline) and the
    :mod:`repro_torch.service` event loop (many jobs, one shared
    platform — each affected job is frozen against its own sub-platform).
    ``proc_map`` carries assignments across the event
    (old index → new index, ``None`` for a lost processor); in-flight
    blocks restart, and survive *pinned* to their processor.

    Every surviving in-flight block is also *priced*: restart-in-place
    on its (possibly slowed) processor vs. migrating — re-transferring
    its already-materialized inputs (edge volumes from completed
    producer blocks) to the best other processor and recomputing there.
    The verdicts land in ``checkpoint_decisions`` (and on the
    :class:`~repro_torch.scenario.report.MigrationRecord`); with
    ``price_migration=True`` a migrate-wins block is left *unpinned* so
    the replan may actually move it.  The default keeps the historical
    always-pin behaviour — pricing is then advisory only.  Execution
    stays restart-based either way (no partial-block state is carried);
    the pricing models where the restart happens, not a mid-block
    checkpoint image.
    """
    with trace_span("scenario.freeze", rel=rel):
        return _freeze_prefix(wf, mapping, platform, rel, new_platform,
                              proc_map, comm=comm,
                              price_migration=price_migration)


def _freeze_prefix(
    wf: Workflow,
    mapping,
    platform: Platform,
    rel: float,
    new_platform: Platform,
    proc_map: dict[int, int | None],
    *,
    comm="contention-free",
    price_migration: bool = False,
) -> FrozenPrefix:
    q = mapping.quotient
    blocks, edges = build_specs(q, platform)
    trace = run_engine(blocks, edges, resolve_comm(comm), platform,
                       record_events=False, stop_time=rel)
    completed_vids = _frozen_blocks(trace, q)
    inflight_vids = set(trace.start) - completed_vids

    completed_local: set[int] = set()
    for vid in completed_vids:
        completed_local |= q.members[vid]
    sub, sub_map = residual_workflow(wf, completed_local)
    inv = {u: i for i, u in enumerate(sub_map)}
    res_blocks: list[list[int]] = []
    res_procs: list[int | None] = []
    old_names: list[str] = []
    pinned: set[int] = set()
    restarted_tasks = restarted_blocks = 0
    lost_work = 0.0
    decisions: list[dict] = []
    # materialized inputs per in-flight block: edge volumes whose
    # producer block durably completed — what a migration re-transfers
    inputs_vol = {vid: 0.0 for vid in inflight_vids}
    for e in edges:
        if e.dst in inputs_vol and e.src in completed_vids:
            inputs_vol[e.dst] += e.volume
    for vid in sorted(q.members):
        if vid in completed_vids:
            continue
        members = sorted(inv[u] for u in q.members[vid])
        old_pj = q.proc[vid]
        new_pj = proc_map.get(old_pj)
        b = len(res_blocks)
        res_blocks.append(members)
        res_procs.append(new_pj)
        old_names.append(platform.procs[old_pj].name)
        if vid in inflight_vids:
            restarted_blocks += 1
            restarted_tasks += len(members)
            # compute time thrown away (capped at the full duration
            # for delivered-but-undurable blocks)
            elapsed = (min(rel, trace.finish.get(vid, rel))
                       - trace.start[vid])
            lost_work += elapsed * platform.procs[old_pj].speed
            if new_pj is not None:
                # price restart-in-place vs migrate-with-inputs on the
                # post-event platform
                w = q.weight[vid]
                vol = inputs_vol[vid]
                restart_cost = w / new_platform.procs[new_pj].speed
                migrate_cost = None
                migrate_to = None
                for j in range(new_platform.k):
                    if j == new_pj:
                        continue
                    c = (w / new_platform.procs[j].speed
                         + vol / new_platform.bandwidth_between(new_pj, j))
                    if migrate_cost is None or c < migrate_cost:
                        migrate_cost, migrate_to = c, j
                verdict = ("migrate" if migrate_cost is not None
                           and migrate_cost < restart_cost
                           else "restart-in-place")
                applied = price_migration and verdict == "migrate"
                decisions.append({
                    "block": b, "tasks": len(members),
                    "proc": new_platform.procs[new_pj].name,
                    "inputs_volume": vol,
                    "restart_cost": restart_cost,
                    "migrate_cost": migrate_cost,
                    "migrate_to": (new_platform.procs[migrate_to].name
                                   if migrate_to is not None else None),
                    "decision": verdict,
                    "applied": applied,
                })
                if not applied:
                    pinned.add(b)
    state = ResumeState(wf=sub, platform=new_platform,
                        blocks=res_blocks, proc_of_block=res_procs,
                        pinned=pinned)
    return FrozenPrefix(
        state=state, sub_map=list(sub_map),
        completed_local=completed_local,
        completed_vids=completed_vids, inflight_vids=inflight_vids,
        old_names=old_names, restarted_tasks=restarted_tasks,
        restarted_blocks=restarted_blocks, lost_work=lost_work,
        checkpoint_decisions=decisions,
    )


def _group_dict(group: list[PlatformEvent]) -> dict:
    if len(group) == 1:
        return group[0].to_dict()
    return {
        "time": group[0].time,
        "kind": "+".join(e.kind for e in group),
        "detail": "; ".join(e.describe() for e in group),
        "events": [e.to_dict() for e in group],
    }


def _migration_record(
    te: float,
    policy_name: str,
    state: ResumeState,
    old_names: list[str],
    report,
    new_platform: Platform,
    restarted_tasks: int,
    restarted_blocks: int,
    lost_work: float,
    checkpoint_decisions: list[dict] | None = None,
) -> MigrationRecord:
    moved_tasks = moved_blocks = 0
    displaced_tasks = displaced_blocks = 0
    moves: dict[tuple[str, str], int] = {}
    if report.feasible:
        q2 = report.best.quotient
        new_name_of_task: dict[int, str] = {}
        for vid, members in q2.members.items():
            nm = new_platform.procs[q2.proc[vid]].name
            for u in members:
                new_name_of_task[u] = nm
        for b, members in enumerate(state.blocks):
            old_name = old_names[b]
            survived = state.proc_of_block[b] is not None
            block_moved = False
            for u in members:
                nn = new_name_of_task[u]
                if nn != old_name:
                    block_moved = True
                    moves[(old_name, nn)] = moves.get((old_name, nn),
                                                      0) + 1
                    if survived:
                        moved_tasks += 1
                    else:
                        displaced_tasks += 1
            if block_moved:
                if survived:
                    moved_blocks += 1
                else:
                    displaced_blocks += 1
    return MigrationRecord(
        time=te, policy=policy_name,
        moved_tasks=moved_tasks, moved_blocks=moved_blocks,
        displaced_tasks=displaced_tasks,
        displaced_blocks=displaced_blocks,
        restarted_tasks=restarted_tasks,
        restarted_blocks=restarted_blocks,
        lost_work=lost_work,
        moves=[[a, b, n] for (a, b), n in sorted(moves.items())],
        checkpoint_decisions=list(checkpoint_decisions or []),
    )


def run_scenario(
    scenario: Scenario,
    policy="pinned-warm-start",
    *,
    config: SchedulerConfig | None = None,
    sim_options: dict | None = None,
    initial_report=None,
    price_migration: bool = False,
) -> TimelineReport:
    """Execute ``scenario`` under ``policy``; see module docstring.

    ``config`` drives every Scheduler invocation (initial plan, cold
    replans, warm starts alike).  ``sim_options`` feed the per-segment
    simulations (``comm=...``, ``jitter=...``); when
    ``config.simulate`` is set, the scheduler's own ``sim_options``
    win and the pipeline-attached :class:`~repro_torch.sim.SimReport` is
    reused instead of re-simulating.  The headline traces stay
    deterministic either way, so where an execution pauses never
    depends on jitter replicas.  ``initial_report`` short-circuits the
    segment-0 plan with a precomputed
    :class:`~repro_torch.core.scheduler.ScheduleReport` for this exact
    workflow/platform (policy sweeps over one scenario replan from the
    same start without re-running the k' sweep each time).
    ``price_migration=True`` lets the checkpoint pricing in
    :func:`freeze_prefix` unpin in-flight blocks whose materialized
    inputs are cheaper to move than to recompute in place; the verdicts
    appear in the migration log either way.
    """
    t_wall = time.perf_counter()
    cfg = config if config is not None else SchedulerConfig()
    pol = resolve_policy(policy)
    # When the pipeline simulates (cfg.simulate), its sim_options — even
    # the empty default — govern the pause engine too, so the frozen
    # prefix is always classified under the same comm model as the
    # reused report.sim.
    sim_kw = dict(cfg.sim_options or {}) if cfg.simulate \
        else dict(sim_options or {})

    wf = scenario.workflow
    platform = scenario.platform
    task_ids = list(range(wf.n))
    completed_total = 0
    events = _event_groups(scenario.events)
    event_dicts = [e.to_dict()
                   for e in sorted(scenario.events, key=lambda e: e.time)]
    segments: list[SegmentReport] = []
    migrations: list[MigrationRecord] = []
    replan_times: list[float] = []
    seg_event: dict | None = None
    infeas = None
    failed_at: float | None = None
    t = 0.0

    report = (initial_report if initial_report is not None
              else Scheduler(cfg).schedule(wf, platform))
    if not report.feasible:
        return TimelineReport(
            scenario=scenario.name, policy=pol.name, segments=[],
            events=event_dicts, migrations=[], makespan=None,
            feasible=False, infeasibility=report.infeasibility,
            failed_at=0.0, total_time_s=time.perf_counter() - t_wall,
        )

    carry_sim = None
    for group in events:
        te = group[0].time
        res = report.best
        seg_sim = report.sim if report.sim is not None else simulate(
            res, platform, **sim_kw)
        rel = te - t
        if rel >= seg_sim.horizon:
            # the plan completes before the event fires: the remaining
            # timeline cannot affect this workflow
            carry_sim = seg_sim  # final segment reuses it
            break

        segments.append(SegmentReport(
            index=len(segments), t_start=t, event=seg_event,
            platform_name=platform.name, n_procs=platform.k,
            n_tasks=wf.n, completed_before=completed_total,
            report=report, sim=seg_sim, executed_until=rel,
            task_ids=task_ids, mapping=res, platform=platform,
        ))

        # -- apply the event group, pause, freeze, extract --------- #
        new_platform, proc_map = apply_event_group(group, platform)
        fz = freeze_prefix(
            wf, res, platform, rel, new_platform, proc_map,
            comm=sim_kw.get("comm", "contention-free"),
            price_migration=price_migration)
        completed_total += len(fz.completed_local)
        state = fz.state

        # -- replan ------------------------------------------------ #
        t0 = time.perf_counter()
        with trace_span("scenario.replan", policy=pol.name, t_event=te):
            report = pol.replan(state, cfg)
        replan_times.append(time.perf_counter() - t0)
        migrations.append(_migration_record(
            te, pol.name, state, fz.old_names, report, new_platform,
            fz.restarted_tasks, fz.restarted_blocks, fz.lost_work,
            fz.checkpoint_decisions))

        t = te
        wf = state.wf
        task_ids = [task_ids[u] for u in fz.sub_map]
        platform = new_platform
        seg_event = _group_dict(group)
        if not report.feasible:
            infeas = report.infeasibility
            failed_at = te
            break

    if infeas is None:
        res = report.best
        seg_sim = (report.sim if report.sim is not None
                   else carry_sim if carry_sim is not None
                   else simulate(res, platform, **sim_kw))
        segments.append(SegmentReport(
            index=len(segments), t_start=t, event=seg_event,
            platform_name=platform.name, n_procs=platform.k,
            n_tasks=wf.n, completed_before=completed_total,
            report=report, sim=seg_sim, executed_until=None,
            task_ids=task_ids, mapping=res, platform=platform,
        ))
        makespan = t + seg_sim.makespan
        feasible = True
    else:
        makespan = None
        feasible = False

    return TimelineReport(
        scenario=scenario.name, policy=pol.name, segments=segments,
        events=event_dicts, migrations=migrations, makespan=makespan,
        feasible=feasible, infeasibility=infeas, failed_at=failed_at,
        total_time_s=time.perf_counter() - t_wall,
        replan_times_s=replan_times,
    )
