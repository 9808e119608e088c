"""Elastic rescale: losing nodes = a one-event scenario.

The framework's response has two halves:

1. **State**: checkpoints are saved unsharded (gathered); restoring
   onto the surviving mesh is just ``load_pytree`` into the new mesh's
   tensors (``repro_torch.checkpoint``).
2. **Placement**: the paper's scheduler re-plans.  A node failure is
   *exactly* the situation DagHetPart was designed for — a platform
   whose memory/speed profile changed — so :func:`rescale_plan` lowers
   the model to its workflow DAG, wraps the failure in a
   :class:`repro_torch.scenario.ProcFailure` timeline and runs it through
   :func:`repro_torch.scenario.run_scenario`.

Migration note
--------------
``rescale_plan`` used to raise ``RuntimeError`` when even the
pre-failure fleet could not hold the model and returned plans built on
the deprecated ``MappingResult | None`` contract.  It now *always*
returns a :class:`RescaleReport` backed by a
:class:`~repro_torch.scenario.TimelineReport`: infeasibility (before or
after the failure) is a structured
:class:`~repro_torch.core.scheduler.Infeasibility` on
``report.infeasibility``, the stitched timeline (Gantt, migration log,
per-segment reports) rides on ``report.timeline``, and ``at`` /
``policy`` select *when* the failure strikes and *how* to replan
(``"full-replan"`` — the old cold-replan behaviour and still the
default — or ``"pinned-warm-start"`` to keep completed/in-flight work
in place).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.autoshard import PartitionPlan, _distill, default_microbatches
from repro_torch.core.modelgraph import build_model_graph
from repro_torch.core.platform import Platform
from repro_torch.core.scheduler import Infeasibility, SchedulerConfig
from repro_torch.scenario import ProcFailure, Scenario, TimelineReport, run_scenario

__all__ = ["rescale_plan", "RescaleReport"]


@dataclass
class RescaleReport:
    """Outcome of re-planning placement around a processor failure.

    ``old_plan`` / ``new_plan`` are distilled
    :class:`~repro_torch.core.autoshard.PartitionPlan` views of the pre- and
    post-failure mappings (``None`` where that side was infeasible);
    ``timeline`` the full scenario record.  ``moved_tasks`` counts
    migrated + displaced tasks from the timeline's migration log (the
    data moves a deployment would execute).
    """

    old_plan: PartitionPlan | None
    new_plan: PartitionPlan | None
    failed: set[int]
    moved_tasks: int
    est_step_before_s: float | None
    est_step_after_s: float | None
    timeline: TimelineReport = field(repr=False, default=None)

    @property
    def feasible(self) -> bool:
        return self.new_plan is not None

    @property
    def infeasibility(self) -> Infeasibility | None:
        return self.timeline.infeasibility if self.timeline else None


def rescale_plan(cfg, shape, platform: Platform, failed: set[int],
                 *, at: float = 0.0, policy: str = "full-replan",
                 algo: str = "dag_het_part", kprime="auto",
                 workers: int = 1,
                 microbatches: int | None = None) -> RescaleReport:
    """Re-plan placement after losing processors ``failed``.

    ``at`` is the failure time on the simulated execution clock
    (``0.0``: nothing ran yet — the old cold-rescale semantics);
    ``policy`` is any :mod:`repro_torch.scenario` replan policy name.  Never
    raises on infeasibility — read ``report.infeasibility``.
    """
    if microbatches is None:
        microbatches = default_microbatches(shape)
    wf, info = build_model_graph(cfg, shape, microbatches=microbatches)
    scenario = Scenario(wf, platform,
                        [ProcFailure(time=at, procs=frozenset(failed))],
                        name=f"{cfg.name}/{shape.name}-rescale")
    timeline = run_scenario(
        scenario, policy,
        config=SchedulerConfig(algorithm=algo, kprime=kprime,
                               workers=workers))

    old_plan = new_plan = None
    if timeline.segments:
        seg0 = timeline.segments[0]
        old_plan = _distill(cfg, shape, seg0.mapping,
                            seg0.mapping.quotient.wf, info,
                            seg0.platform, algo)
        old_plan.report = seg0.report
        last = timeline.segments[-1]
        if timeline.feasible and last.index > 0:
            info_res = {i: info[g] for i, g in enumerate(last.task_ids)}
            new_plan = _distill(cfg, shape, last.mapping,
                                last.mapping.quotient.wf, info_res,
                                last.platform, algo)
            new_plan.report = last.report
        elif timeline.feasible:
            # failure never fired (e.g. ``at`` past completion)
            new_plan = old_plan
    moved = sum(m.moved_tasks + m.displaced_tasks
                for m in timeline.migrations)
    return RescaleReport(
        old_plan=old_plan,
        new_plan=new_plan,
        failed=set(failed),
        moved_tasks=moved,
        est_step_before_s=(old_plan.est_step_s if old_plan else None),
        est_step_after_s=(new_plan.est_step_s if new_plan else None),
        timeline=timeline,
    )
