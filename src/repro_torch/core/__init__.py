"""repro_torch.core — the paper's contribution, the port's copy of
``repro/core``.

Memory-constrained partitioning and mapping of DAG workflows onto
heterogeneous platforms (Kulagina, Meyerhenke, Benoit — ICPP'24).  Host
code over Python dicts and numpy arrays, kept in numpy on purpose: the
flat paths' floats come from sequential ``np.bincount`` sums and
``np.lexsort`` ranks, so every decision and every makespan is bit-equal
to the reference's on the same inputs (``tests/test_torch_sched_parity.py``).

* :mod:`repro_torch.core.dag` — workflow / quotient-graph model,
* :mod:`repro_torch.core.platform` — heterogeneous clusters (paper
  Tables 2–3) and the H100 fleet presets,
* :mod:`repro_torch.core.memdag` — min-peak-memory traversals (MemDag role),
* :mod:`repro_torch.core.partitioner` — acyclic DAG partitioning (dagP role),
* :mod:`repro_torch.core.makespan` — bottom weights / makespan / critical path,
* :mod:`repro_torch.core.incremental` — delta-evaluated makespan engine
  (bounded probes + transactional merges for the heuristic hot paths),
* :mod:`repro_torch.core.baseline` — DagHetMem,
* :mod:`repro_torch.core.heuristic` — DagHetPart (the four-step heuristic),
* :mod:`repro_torch.core.scheduler` — the unified Scheduler/Plan API,
* :mod:`repro_torch.core.workflows` — workflow-instance generators,
* :mod:`repro_torch.core.modelgraph` — model architectures as workflow DAGs,
* :mod:`repro_torch.core.autoshard` — placement planning for the port's
  models on H100 fleets,
* :mod:`repro_torch.core.counters` — perf-cache counters surfaced as
  ``ScheduleReport.cache_stats``.

Spans and metrics come from :mod:`repro_torch.obs`.  The layers built on
top of this package: the discrete-event replay (:mod:`repro_torch.sim`,
the ``simulate`` stage and ``validate_mapping(..., memory_trace=True)``),
the reliability and energy objectives (:mod:`repro_torch.objectives`, the
``reliability`` and ``energy`` stages) and scenario timelines with
replanning (:mod:`repro_torch.scenario`, and
:func:`repro_torch.runtime.rescale_plan` on top), steady-state throughput
(:mod:`repro_torch.throughput`, the ``throughput`` stage) and the
multi-tenant service loop (:mod:`repro_torch.service`).

Scheduling API
--------------
:class:`~repro_torch.core.scheduler.Scheduler` is the entry point for all
mapping runs.  It executes registered pipeline *stages*; the paper's
steps map to stage names as follows:

========  ============  ===============================================
paper     stage name    role
========  ============  ===============================================
Step 1    partition     acyclic k'-way partition (dagP role)
Step 2    assign        BiggestAssign/FitBlock (Algorithms 1–2)
Step 3    merge         MergeUnassignedToAssigned (Algorithms 3–4)
Step 4    swap          best-improvement block swaps (Algorithm 5)
Step 4    idle_moves    critical-path moves to faster idle processors
§4.1      pack          DagHetMem min-peak traversal packing
========  ============  ===============================================

``schedule(wf, platform, kprime=[1, 4, 9], workers=4)`` sweeps the k'
values (in parallel for ``workers > 1``, bit-identical best makespans)
and always returns a :class:`~repro_torch.core.scheduler.ScheduleReport`:
the best :class:`MappingResult` *or* a structured
:class:`~repro_torch.core.scheduler.Infeasibility`, plus per-stage
timings, per-run cache statistics (``cache_stats``) and the full
k'→makespan sweep trace (``to_json``/``from_json``).  The legacy
:func:`dag_het_part` / :func:`dag_het_mem` entry points are deprecated
thin wrappers over it.  :meth:`Scheduler.resume` replans warm from a
:class:`~repro_torch.core.scheduler.ResumeState` (residual workflow,
inherited partition, per-block processor, pinned blocks), and
:meth:`Scheduler.seeded` starts from a cached partition.

Scaling
-------
The k' sweep parallelizes over a process pool; Step 2 runs on flat numpy
arrays (a cached CSR view of the workflow; every block's
``during``/``delta`` constants via sequential ``np.bincount``, the greedy
ready-heap popping ``np.lexsort`` ranks); committed Step-3 merges keep
topological ranks exact through Pearce–Kelly localized reordering; Step-4
rescans reuse probe verdicts whose dependency region an applied swap did
not touch.  Step 1 rides the same pattern (:func:`set_step1_impl`), and
``SchedulerConfig(step1_multilevel=True)`` coarsens by acyclic heavy-edge
matching.  Every flat or cached layer is decision-for-decision identical
to the scalar path (``tests/test_torch_sched_core.py``).

Placement
---------
:func:`repro_torch.core.autoshard.plan` lowers a ``ModelConfig`` ×
``ShapeConfig`` to a workflow (:mod:`~repro_torch.core.modelgraph`) and
places it on a fleet, e.g. ``plan(get_config("llama3_8b"),
shape_by_name("prefill_32k"), h100_fleet_si({"h100": 1}))``; ``None``
means the fleet cannot hold the model.
"""
from .dag import QuotientGraph, Workflow, build_quotient
from .platform import (
    Platform,
    ProcPower,
    Processor,
    default_cluster,
    large_cluster,
    less_het_cluster,
    more_het_cluster,
    no_het_cluster,
    small_cluster,
    H100_KINDS,
    h100_fleet,
    h100_fleet_si,
)
from .incremental import IncrementalEvaluator
from .makespan import bottom_weights, bottom_weights_flat, critical_path, makespan
from .memdag import (
    block_requirement,
    block_requirement_witness,
    exact_min_peak,
    greedy_min_peak,
    set_step2_impl,
    simulate_peak,
    simulate_peak_members,
    step2_impl,
)
from .partitioner import (
    acyclic_partition,
    edge_cut,
    partition_block,
    set_step1_impl,
    step1_impl,
)
from .baseline import MappingResult, dag_het_mem, validate_mapping
from .heuristic import dag_het_part, kprime_sweep_values
from .scheduler import (
    Infeasibility,
    MappingSummary,
    ResumeState,
    ScheduleReport,
    Scheduler,
    SchedulerConfig,
    Stage,
    SweepPoint,
    schedule,
)
from .workflows import (
    FAMILIES,
    WorkflowValidationError,
    generate_workflow,
    random_layered_dag,
    real_like_workflows,
    residual_workflow,
)

__all__ = [
    "Workflow", "QuotientGraph", "build_quotient",
    "Platform", "ProcPower", "Processor",
    "default_cluster", "small_cluster", "large_cluster",
    "more_het_cluster", "less_het_cluster", "no_het_cluster",
    "H100_KINDS", "h100_fleet", "h100_fleet_si",
    "bottom_weights", "bottom_weights_flat", "critical_path", "makespan",
    "IncrementalEvaluator",
    "block_requirement", "block_requirement_witness",
    "exact_min_peak", "greedy_min_peak",
    "set_step2_impl", "step2_impl",
    "simulate_peak", "simulate_peak_members",
    "acyclic_partition", "edge_cut", "partition_block",
    "set_step1_impl", "step1_impl",
    "MappingResult", "dag_het_mem", "dag_het_part", "validate_mapping",
    "Scheduler", "SchedulerConfig", "ScheduleReport", "SweepPoint",
    "Infeasibility", "MappingSummary", "ResumeState", "Stage", "schedule",
    "kprime_sweep_values",
    "FAMILIES", "generate_workflow", "real_like_workflows",
    "random_layered_dag", "residual_workflow",
    "WorkflowValidationError",
]
