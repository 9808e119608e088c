"""Replan policies: what to do with the residual plan at an event.

A policy turns a :class:`~repro_torch.core.scheduler.ResumeState` (residual
workflow + inherited partition + new platform) into the next segment's
:class:`~repro_torch.core.scheduler.ScheduleReport`:

* :class:`PinnedWarmStart` — ``Scheduler.resume``: inherit the
  partition, keep surviving assignments, pin in-flight blocks, repair
  orphans via Step 3, pin-aware Step-4 refinement.  The cheap reaction.
* :class:`FullReplan` — cold ``Scheduler.schedule`` of the residual on
  the new platform (full k' sweep).  The quality ceiling; what
  warm-starting is measured against.
* :class:`NoReplan` — keep the inherited assignment verbatim (only the
  platform changed under it).  Structurally infeasible when an event
  removed a processor the plan still needs — the do-nothing baseline.

Policies are resolved by name (:func:`resolve_policy`); any object with
``name`` and ``replan(state, config)`` works.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Protocol, runtime_checkable

from repro_torch.core.scheduler import (
    ResumeState,
    ScheduleReport,
    Scheduler,
    SchedulerConfig,
)

__all__ = [
    "FullReplan",
    "NoReplan",
    "PinnedWarmStart",
    "ReplanPolicy",
    "resolve_policy",
]


@runtime_checkable
class ReplanPolicy(Protocol):
    """Protocol: produce the next segment's plan from a resume state."""

    name: str

    def replan(self, state: ResumeState,
               config: SchedulerConfig) -> ScheduleReport: ...


class PinnedWarmStart:
    """Warm-start replan; never moves completed or in-flight work.

    A warm start inherits the old partition and cannot split blocks, so
    a displaced block may have no feasible home even when a cold replan
    would find one (splitting displaced blocks FitBlock-style is a
    ROADMAP follow-on).  ``cold_fallback=True`` escalates exactly that
    case to a :class:`FullReplan` instead of reporting infeasibility —
    pins are forfeited, but the scenario completes.
    """

    def __init__(self, cold_fallback: bool = False) -> None:
        self.cold_fallback = cold_fallback
        self.name = ("pinned-warm-start+cold-fallback" if cold_fallback
                     else "pinned-warm-start")

    def replan(self, state: ResumeState,
               config: SchedulerConfig) -> ScheduleReport:
        report = Scheduler(config).resume(state)
        if not report.feasible and self.cold_fallback:
            return Scheduler(config).schedule(state.wf, state.platform)
        return report


class FullReplan:
    """Cold replan of the residual (ignores the inherited partition)."""

    name = "full-replan"

    def replan(self, state: ResumeState,
               config: SchedulerConfig) -> ScheduleReport:
        return Scheduler(config).schedule(state.wf, state.platform)


class NoReplan:
    """Keep the inherited plan as-is, re-priced on the new platform.
    Merge/refinement stages are skipped, so any block whose processor
    disappeared surfaces as a structured infeasibility.  Like the other
    policies, the pipeline attaches a fresh :class:`~repro_torch.sim.SimReport`
    only when ``config.simulate`` is on — :func:`~repro_torch.scenario.run_scenario`
    simulates kept segments itself otherwise."""

    name = "no-replan"

    def replan(self, state: ResumeState,
               config: SchedulerConfig) -> ScheduleReport:
        cfg = replace(config, stages=("warm_start", "simulate"))
        return Scheduler(cfg).resume(state)


_POLICIES = {
    "pinned-warm-start": PinnedWarmStart,
    "warm-start": PinnedWarmStart,
    "warm": PinnedWarmStart,
    "pinned-warm-start+cold-fallback":
        lambda: PinnedWarmStart(cold_fallback=True),
    "warm+fallback": lambda: PinnedWarmStart(cold_fallback=True),
    "full-replan": FullReplan,
    "cold": FullReplan,
    "no-replan": NoReplan,
    "static": NoReplan,
}


def resolve_policy(policy) -> ReplanPolicy:
    """A policy instance from a name, class or ready instance."""
    if isinstance(policy, str):
        try:
            return _POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown policy {policy!r}; known: "
                f"{sorted(set(_POLICIES))}"
            ) from None
    if isinstance(policy, type):
        return policy()
    return policy
