"""repro_torch.scenario — event-driven platform timelines with replanning.

The paper maps a workflow onto a *static* heterogeneous platform; this
subsystem makes the platform a timeline.  A :class:`Scenario` is a
workflow + platform + ordered :class:`PlatformEvent` list
(:class:`ProcFailure`, :class:`ProcArrival`, :class:`SpeedChange`,
:class:`LinkDegrade`), and :func:`run_scenario` executes it end to
end: simulate (:mod:`repro_torch.sim`), pause at each event
(``run_engine(..., stop_time=t)``), freeze the completed prefix,
extract the residual DAG
(:func:`repro_torch.core.workflows.residual_workflow`), replan under a
pluggable policy, and stitch the epochs into a
:class:`TimelineReport`::

    from repro_torch.scenario import ProcFailure, Scenario, run_scenario
    sc = Scenario(wf, platform, [ProcFailure(time=40.0, procs={3, 7})])
    tl = run_scenario(sc, policy="pinned-warm-start")
    tl.makespan                  # stitched end-to-end completion time
    tl.migrations[0].moved_tasks # what the replan moved
    print(tl.gantt())            # event markers + restarted work

Replan policies (:mod:`repro_torch.scenario.policies`):
``"pinned-warm-start"`` — :meth:`repro_torch.core.scheduler.Scheduler.resume`
with the inherited partition, surviving assignments kept and in-flight
blocks pinned; ``"full-replan"`` — cold reschedule of the residual
(the quality ceiling warm-starting is measured against);
``"no-replan"`` — keep the plan verbatim (structured infeasibility
when it needed a lost processor).

An empty event timeline reproduces ``Scheduler(config).schedule(wf,
platform)`` bit-exactly — the subsystem's identity anchor.

:mod:`repro_torch.scenario.fuzz` turns these invariants into a harness:
:func:`fuzz_scenarios` generates seeded random workflows/platforms/
timelines (failure traces drawn from ``Platform.failure_rates``,
simultaneous events in the canonical order of
:func:`event_sort_key`) and drives every policy plus the service loop
through them — ``python -m repro_torch.scenario.fuzz`` runs the large
corpus (the service check needs the service loop, a later part of the
port: until it lands, pass ``service=False``).  Simultaneous
events are ordered canonically (``validate_event_timeline`` rejects
other permutations with code ``"unsorted-tie"``), so timelines replay
identically from JSON round-trips; :func:`canonical_event_order` sorts
any event list into the accepted order.
"""
from __future__ import annotations

from .events import (
    EventTimelineError,
    LinkDegrade,
    PlatformEvent,
    ProcArrival,
    ProcFailure,
    SpeedChange,
    canonical_event_order,
    event_from_dict,
    event_sort_key,
    validate_event_timeline,
)
from .fuzz import (
    FUZZ_POLICIES,
    FuzzCase,
    FuzzReport,
    FuzzViolation,
    fuzz_scenarios,
    generate_case,
)
from .policies import (
    FullReplan,
    NoReplan,
    PinnedWarmStart,
    ReplanPolicy,
    resolve_policy,
)
from .report import MigrationRecord, SegmentReport, TimelineReport
from .runner import (
    FrozenPrefix,
    Scenario,
    apply_event_group,
    freeze_prefix,
    run_scenario,
)

__all__ = [
    "EventTimelineError",
    "FUZZ_POLICIES",
    "FrozenPrefix",
    "FullReplan",
    "FuzzCase",
    "FuzzReport",
    "FuzzViolation",
    "LinkDegrade",
    "MigrationRecord",
    "NoReplan",
    "PinnedWarmStart",
    "PlatformEvent",
    "ProcArrival",
    "ProcFailure",
    "ReplanPolicy",
    "Scenario",
    "SegmentReport",
    "SpeedChange",
    "TimelineReport",
    "apply_event_group",
    "canonical_event_order",
    "event_from_dict",
    "event_sort_key",
    "freeze_prefix",
    "fuzz_scenarios",
    "generate_case",
    "resolve_policy",
    "run_scenario",
    "validate_event_timeline",
]
