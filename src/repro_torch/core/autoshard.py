"""Scheduler-driven placement: the paper's algorithm as the framework's
planning layer.

``plan(cfg, shape, platform)`` lowers the architecture to a workflow
DAG (:mod:`modelgraph`), runs DagHetPart (or the DagHetMem baseline)
against a heterogeneous device fleet, and distills the resulting
partition into a :class:`PartitionPlan`:

* contiguous *pipeline stages* (topological order of the quotient
  graph) with their processor assignments,
* per-(layer, expert) placement for MoE layers — expert parallelism
  emerges from the partitioner splitting parallel expert tasks,
* the estimated step latency (the paper's makespan, in seconds on the
  SI fleets such as :func:`~repro_torch.core.platform.h100_fleet_si`),
* per-stage memory requirements (the MemDag peak of each block).

Elastic rescale (node loss) = re-run ``plan`` on ``platform.without``,
then remap — see ``repro_torch.runtime.elastic``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig, ShapeConfig

from .baseline import MappingResult, validate_mapping
from .dag import Workflow
from .makespan import critical_path
from .modelgraph import TaskInfo, build_model_graph
from .platform import Platform
from .scheduler import ScheduleReport, Scheduler, SchedulerConfig

__all__ = ["PartitionPlan", "default_microbatches", "plan"]


def default_microbatches(shape: ShapeConfig) -> int:
    """The planning default: 8 for training shapes (pipelined working
    set), 1 otherwise.  Shared with :func:`repro_torch.runtime.elastic.
    rescale_plan` so pre/post-failure plans lower the same DAG."""
    return 8 if shape.kind == "train" else 1


@dataclass
class PartitionPlan:
    arch: str
    shape: str
    algo: str
    n_stages: int
    stage_of_task: dict[int, int]
    proc_of_stage: list[int]
    stage_members: list[list[str]]          # task labels per stage
    expert_placement: dict[tuple[int, int], int]  # (layer, expert) -> stage
    stage_memory: list[float]               # bytes (MemDag peak)
    est_step_s: float                       # paper makespan (fill latency)
    est_bottleneck_s: float                 # steady-state pipeline bound:
                                            # max stage compute+comm time
    critical_stages: list[int]
    valid: bool
    mapping: MappingResult = field(repr=False, default=None)
    workflow: Workflow = field(repr=False, default=None)
    info: dict = field(repr=False, default=None)
    report: ScheduleReport = field(repr=False, default=None)


def plan(cfg: ModelConfig, shape: ShapeConfig, platform: Platform,
         *, algo: str = "dag_het_part", kprime="auto", workers: int = 1,
         microbatches: int | None = None) -> PartitionPlan | None:
    """Compute a placement plan; None if the fleet can't hold the model.

    Scheduling goes through :class:`repro_torch.core.scheduler.Scheduler`;
    the full :class:`ScheduleReport` (sweep trace, stage timings, or
    the infeasibility diagnosis) rides on ``PartitionPlan.report``, and
    ``workers > 1`` parallelizes the k' sweep.  ``microbatches``
    defaults to 8 for training shapes (pipelined working set) and 1
    otherwise.
    """
    if microbatches is None:
        microbatches = default_microbatches(shape)
    wf, info = build_model_graph(cfg, shape, microbatches=microbatches)
    report = Scheduler(SchedulerConfig(
        algorithm=algo, kprime=kprime, workers=workers,
    )).schedule(wf, platform)
    if not report.feasible:
        return None
    p = _distill(cfg, shape, report.best, wf, info, platform, algo)
    p.report = report
    return p


def _distill(cfg, shape, result, wf, info, platform, algo):
    from .memdag import block_requirement

    q = result.quotient
    order = q.topological_order()
    stage_of_vid = {vid: i for i, vid in enumerate(order)}
    stage_of_task: dict[int, int] = {}
    stage_members: list[list[str]] = [[] for _ in order]
    expert_placement: dict[tuple[int, int], int] = {}
    for vid, members in q.members.items():
        st = stage_of_vid[vid]
        for u in sorted(members):
            stage_of_task[u] = st
            stage_members[st].append(wf.labels[u])
            ti: TaskInfo = info[u]
            if ti.kind == "expert":
                expert_placement[(ti.layer, ti.expert)] = st
    stage_memory = [
        block_requirement(wf, sorted(q.members[vid])) for vid in order
    ]
    crit = [stage_of_vid[v] for v in critical_path(q, platform)]
    bottleneck = max(
        q.weight[vid] / platform.speed(q.proc[vid])
        + sum(q.succ[vid].values()) / platform.bandwidth
        for vid in order
    )
    return PartitionPlan(
        arch=cfg.name,
        shape=shape.name,
        algo=algo,
        n_stages=len(order),
        stage_of_task=stage_of_task,
        proc_of_stage=[q.proc[vid] for vid in order],
        stage_members=stage_members,
        expert_placement=expert_placement,
        stage_memory=stage_memory,
        est_step_s=result.makespan,
        est_bottleneck_s=bottleneck,
        critical_stages=crit,
        valid=validate_mapping(wf, result) == [],
        mapping=result,
        workflow=wf,
        info=info,
    )
