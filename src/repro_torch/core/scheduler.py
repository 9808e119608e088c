"""Unified Scheduler/Plan API: the paper's heuristics as a pipeline.

The four-step heuristic (paper §4.2) and the DagHetMem baseline (§4.1)
are *pipelines* of stages, not opaque functions.  This module makes
that structure first-class:

* :class:`Stage` — protocol for one pipeline step; implementations are
  registered by name (:func:`register_stage`) and composed into
  algorithm pipelines (:data:`PIPELINES`, :func:`register_pipeline`),
* :class:`SchedulerConfig` — algorithm, k'-sweep policy, exact-DP
  limit, per-step toggles, time budget, worker count and the
  ``on_sweep_result`` reporting callback,
* :class:`Scheduler` — the facade: ``Scheduler(config).schedule(wf,
  platform)`` runs the k' sweep (serially or on a
  ``concurrent.futures`` process pool with per-worker Step-2 memos)
  and **always** returns a :class:`ScheduleReport` — never ``None``,
* :class:`ScheduleReport` — the best :class:`MappingResult` *or* a
  structured :class:`Infeasibility` (which stage failed, tightest
  memory gap, smallest k' attempted), plus per-stage timings, the full
  k'→makespan sweep trace and ``to_json()``/``from_json()`` for
  benchmark artifacts.

Paper-step ↔ stage-name map::

    Step 1  partition    acyclic k'-way partition (dagP role)
    Step 2  assign       BiggestAssign/FitBlock (Algorithms 1–2)
    Step 3  merge        MergeUnassignedToAssigned (Algorithms 3–4)
    Step 4  swap         best-improvement block swaps (Algorithm 5)
    Step 4  idle_moves   critical-path moves to faster idle processors
    §4.1    pack         DagHetMem min-peak traversal packing
    —       simulate     discrete-event replay (repro_torch.sim), off by
                         default (``SchedulerConfig(simulate=True)``)

Determinism: every stage is deterministic, and the sweep reduction
scans results in sweep order with a strict ``<``, so ``workers=N`` and
``workers=1`` pick bit-identical best makespans (the per-worker memos
only cache deterministic pure functions).
"""
from __future__ import annotations

import json
import logging
import time
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Callable, Protocol, Sequence, runtime_checkable

from repro_torch.obs import JsonlSink, ObsConfig, span_events, write_chrome_trace
from repro_torch.obs import tracer as _trc
from repro_torch.obs.metrics import METRICS, RATIO_BOUNDARIES, Histogram
from repro_torch.obs.tracer import trace_span

_log = logging.getLogger(__name__)

from .baseline import MappingResult, _pack_min_peak
from .dag import Workflow, build_quotient
from .heuristic import (
    _Requirements,
    _biggest_assign,
    _idle_moves,
    _memo_witness,
    _merge_unassigned,
    _swap_pass,
    kprime_sweep_values,
)
from .incremental import IncrementalEvaluator
from .partitioner import acyclic_partition
from .platform import Platform

__all__ = [
    "Infeasibility",
    "MappingSummary",
    "PIPELINES",
    "ResumeState",
    "ScheduleReport",
    "Scheduler",
    "SchedulerConfig",
    "Stage",
    "StageContext",
    "SweepPoint",
    "available_stages",
    "get_stage",
    "kprime_sweep_values",
    "register_pipeline",
    "register_stage",
    "schedule",
]


# ---------------------------------------------------------------------- #
# report dataclasses
# ---------------------------------------------------------------------- #
@dataclass
class SweepPoint:
    """One k' attempt of the sweep (k' is ``None`` for sweep-free
    pipelines such as the baseline's single packing run).

    ``cache_stats`` carries the pipeline run's perf-cache counters
    (:mod:`repro_torch.core.counters` deltas: Step-2 flat/scalar dispatch and
    memo reuse, Pearce–Kelly rank repairs vs full refreshes, Step-4
    swap-probe cache hits) — collected per attempt so the parallel
    sweep's per-worker counters aggregate correctly.  ``metrics`` is
    the attempt's non-counter :data:`repro_torch.obs.metrics.METRICS` delta
    (gauges + histogram dicts) under the same bracket, and travels the
    same picklable route from pool workers; ``spans`` holds the
    attempt's finished tracer spans when the worker traced (transient
    — spliced into the parent tracer, never serialized to JSON).
    """

    k_prime: int | None
    makespan: float | None
    feasible: bool
    time_s: float
    stage_times: dict[str, float] = field(default_factory=dict)
    failed_stage: str | None = None
    fail_reason: str | None = None
    memory_gap: float | None = None
    cache_stats: dict[str, int] = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)
    spans: list = field(default_factory=list, repr=False, compare=False)

    def to_dict(self) -> dict:
        return {
            "k_prime": self.k_prime,
            "makespan": self.makespan,
            "feasible": self.feasible,
            "time_s": self.time_s,
            "stage_times": dict(self.stage_times),
            "failed_stage": self.failed_stage,
            "fail_reason": self.fail_reason,
            "memory_gap": self.memory_gap,
            "cache_stats": dict(self.cache_stats),
            "metrics": dict(self.metrics),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SweepPoint":
        return cls(**{k: v for k, v in d.items() if k != "spans"})


@dataclass
class Infeasibility:
    """Structured diagnosis of an infeasible run.

    ``stage`` is the failure of the sweep attempt that got furthest
    through the pipeline; ``tightest_gap`` is the smallest positive
    requirement-minus-capacity deficit observed across the whole sweep
    (how much more memory would have been needed, ``None`` when every
    failure was structural rather than a raw capacity shortfall);
    ``smallest_kprime`` is the smallest k' attempted (``None`` for
    sweep-free runs: the baseline's single packing attempt and
    warm-start replans).

    Warm-start replans (``algorithm="warm_start"``, produced by
    :meth:`Scheduler.resume` and the scenario policies) report through
    the same type: ``stage`` may then also be ``"warm_start"`` (an
    inherited block no longer fits its surviving processor) or
    ``"materialize"`` (blocks left unassigned, e.g. the no-replan
    policy after a failure event).  Scenario timelines surface the
    diagnosis per planning segment and in the migration log of their
    :class:`repro_torch.scenario.TimelineReport`.
    """

    algorithm: str
    stage: str
    reason: str
    tightest_gap: float | None
    smallest_kprime: int | None
    attempts: int

    def to_dict(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "stage": self.stage,
            "reason": self.reason,
            "tightest_gap": self.tightest_gap,
            "smallest_kprime": self.smallest_kprime,
            "attempts": self.attempts,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Infeasibility":
        return cls(**d)


@dataclass
class MappingSummary:
    """JSON-friendly projection of a :class:`MappingResult` (the live
    quotient graph / platform objects stay on ``ScheduleReport.best``)."""

    algo: str
    makespan: float
    k_used: int
    k_prime: int | None
    runtime_s: float
    block_of_task: list[int]
    proc_of_block: dict[int, int]

    @classmethod
    def from_result(cls, res: MappingResult) -> "MappingSummary":
        return cls(
            algo=res.algo,
            makespan=float(res.makespan),
            k_used=int(res.k_used),
            k_prime=res.extras.get("k_prime"),
            runtime_s=float(res.runtime_s),
            block_of_task=[int(b) for b in res.block_of_task()],
            proc_of_block={int(v): int(p)
                           for v, p in sorted(res.quotient.proc.items())},
        )

    def to_dict(self) -> dict:
        return {
            "algo": self.algo,
            "makespan": self.makespan,
            "k_used": self.k_used,
            "k_prime": self.k_prime,
            "runtime_s": self.runtime_s,
            "block_of_task": list(self.block_of_task),
            # JSON objects key by string; keep explicit pairs instead
            "proc_of_block": [[v, p]
                              for v, p in sorted(self.proc_of_block.items())],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MappingSummary":
        d = dict(d)
        d["proc_of_block"] = {int(v): int(p) for v, p in d["proc_of_block"]}
        return cls(**d)


@dataclass
class ScheduleReport:
    """What a :class:`Scheduler` run returns — never ``None``.

    Exactly one of ``summary`` / ``infeasibility`` is set.  ``best``
    carries the live :class:`MappingResult` on feasible runs; it is
    deliberately excluded from JSON and equality (``from_json`` yields
    a report with ``best=None`` but an otherwise identical record).

    ``stage_times`` and ``cache_stats`` aggregate over the whole sweep
    (per-attempt values live on the :class:`SweepPoint`\\ s):
    ``cache_stats`` exposes the perf-cache counters of the run —
    ``step2_flat_blocks`` / ``step2_scalar_blocks`` /
    ``step2_memo_hits`` (flat-array Step 2 and the requirement memo),
    ``rank_pk_repairs`` / ``rank_full_refreshes`` (Pearce–Kelly
    dynamic topological ranks), ``swap_probe_cache_hits`` /
    ``swap_probes`` (Step-4 dependency-region verdict reuse) — see
    docs/benchmarks.md for the full key list.

    ``metrics`` is the run's aggregated non-counter metrics block
    (``{"gauges": ..., "histograms": ...}``, merged over all sweep
    points — e.g. the ``sched_sweep_point_s`` plan-latency histogram;
    see docs/observability.md).  ``spans`` carries the run's finished
    tracer spans when tracing was on (live objects — excluded from
    JSON and equality, like ``best``).
    """

    algorithm: str
    summary: MappingSummary | None
    infeasibility: Infeasibility | None
    sweep: list[SweepPoint]
    stage_times: dict[str, float]
    total_time_s: float
    workers: int
    truncated: bool = False
    cache_stats: dict[str, int] = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)
    spans: list = field(default_factory=list, repr=False, compare=False)
    best: MappingResult | None = field(
        default=None, repr=False, compare=False)

    @property
    def feasible(self) -> bool:
        return self.summary is not None

    @property
    def makespan(self) -> float | None:
        return self.summary.makespan if self.summary else None

    @property
    def sim(self):
        """The best mapping's :class:`repro_torch.sim.SimReport` (present when
        the run included the ``simulate`` stage), else ``None``."""
        return self.best.extras.get("sim") if self.best else None

    @property
    def reliability(self):
        """The best mapping's
        :class:`repro_torch.objectives.ReliabilityReport` (present when the
        run included the ``reliability`` stage and the platform carries
        a failure model), else ``None``."""
        return self.best.extras.get("reliability") if self.best else None

    @property
    def energy(self):
        """The best mapping's :class:`repro_torch.objectives.EnergyReport`
        (present when the run included the ``energy`` stage and the
        platform carries a power model), else ``None``."""
        return self.best.extras.get("energy") if self.best else None

    def to_dict(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "summary": self.summary.to_dict() if self.summary else None,
            "infeasibility": (self.infeasibility.to_dict()
                              if self.infeasibility else None),
            "sweep": [p.to_dict() for p in self.sweep],
            "stage_times": dict(self.stage_times),
            "total_time_s": self.total_time_s,
            "workers": self.workers,
            "truncated": self.truncated,
            "cache_stats": dict(self.cache_stats),
            "metrics": dict(self.metrics),
        }

    def to_json(self, **kw) -> str:
        """Serialize the report record to JSON.

        Covers everything except ``best`` (the live mapping does not
        round-trip; ``from_json`` restores an otherwise identical
        report with ``best=None``) — so the summary's block/processor
        maps, the sweep trace, stage timings and cache stats all
        survive.  Scenario runs embed these serialized reports
        per planning segment inside a
        :class:`repro_torch.scenario.TimelineReport`, next to that report's
        own ``timeline`` (stitched event segments) and migration log —
        deserializing a timeline reconstructs each segment's
        ``ScheduleReport`` through :meth:`from_dict` unchanged.
        """
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleReport":
        return cls(
            algorithm=d["algorithm"],
            summary=(MappingSummary.from_dict(d["summary"])
                     if d.get("summary") else None),
            infeasibility=(Infeasibility.from_dict(d["infeasibility"])
                           if d.get("infeasibility") else None),
            sweep=[SweepPoint.from_dict(p) for p in d.get("sweep", [])],
            stage_times=dict(d.get("stage_times", {})),
            total_time_s=d["total_time_s"],
            workers=d.get("workers", 1),
            truncated=d.get("truncated", False),
            cache_stats=dict(d.get("cache_stats", {})),
            # absent on payloads written without metrics: default to empty
            metrics=dict(d.get("metrics", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "ScheduleReport":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------- #
# stages
# ---------------------------------------------------------------------- #
@dataclass
class StageFailure:
    """Why a stage declared its k' attempt infeasible."""

    stage: str
    reason: str
    gap: float | None  # requirement − capacity deficit where computable


@dataclass
class ResumeState:
    """Warm-start input for :meth:`Scheduler.resume` — a partially
    executed plan lifted onto a (possibly changed) platform.

    ``wf`` is the residual workflow (see
    :func:`repro_torch.core.workflows.residual_workflow`), ``blocks`` its
    partition inherited from the previous plan (residual task ids,
    grouped by surviving block), ``proc_of_block[b]`` the block's
    processor on ``platform`` — ``None`` where the old processor no
    longer exists (the block re-enters Step 3 as unassigned) — and
    ``pinned`` the indices of blocks that must stay on their processor
    (in-flight at the replanning point: warm-start never migrates
    them).  :mod:`repro_torch.scenario` constructs these from a paused
    simulation; hand-built states just need the same shape.
    """

    wf: Workflow
    platform: Platform
    blocks: list[list[int]]
    proc_of_block: list[int | None]
    pinned: set[int] = field(default_factory=set)

    def __post_init__(self) -> None:
        if len(self.blocks) != len(self.proc_of_block):
            raise ValueError("blocks / proc_of_block length mismatch")
        bad = [b for b in self.pinned
               if not 0 <= b < len(self.blocks)
               or self.proc_of_block[b] is None]
        if bad:
            raise ValueError(
                f"pinned block(s) {sorted(bad)[:5]} unassigned or out "
                "of range — a pin needs a surviving processor"
            )


@dataclass
class StageContext:
    """Mutable state threaded through one pipeline run (one k')."""

    wf: Workflow
    platform: Platform
    k_prime: int | None
    exact_limit: int
    memo: dict                      # Step-2 requirement/split memo
    blocks: list[list[int]] | None = None   # Step-1 output
    q: object | None = None                 # quotient graph (post Step 2)
    reqs: _Requirements | None = None
    ev: IncrementalEvaluator | None = None
    result: MappingResult | None = None
    failure: StageFailure | None = None
    sim_options: dict | None = None         # simulate-stage kwargs
    throughput_options: dict | None = None  # throughput-stage kwargs
    objective_options: dict | None = None   # reliability/energy kwargs
    resume: ResumeState | None = None       # warm_start-stage input
    pinned: set[int] = field(default_factory=set)  # vids frozen in place
    step1_multilevel: bool = False          # multilevel Step-1 opt-in
    seed_blocks: list[list[int]] | None = None  # seed_partition-stage input


@runtime_checkable
class Stage(Protocol):
    """One pipeline step: mutate ``ctx``; set ``ctx.failure`` to abort
    the run (structured, never an exception for infeasibility).

    ``toggle`` optionally names the :class:`SchedulerConfig` boolean
    that enables the stage (``None`` ⇒ always on).
    """

    name: str
    toggle: str | None

    def run(self, ctx: StageContext) -> None: ...


class PartitionStage:
    """Step 1: initial acyclic k'-way partition (edge-cut optimizer)."""

    name = "partition"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        assignment = acyclic_partition(ctx.wf, ctx.k_prime,
                                       multilevel=ctx.step1_multilevel)
        groups: dict[int, list[int]] = {}
        for u, b in enumerate(assignment):
            groups.setdefault(b, []).append(u)
        ctx.blocks = [groups[b] for b in sorted(groups)]


class SeedPartitionStage:
    """Step-1 replacement for plan-cache hits: adopt a previously
    computed partition instead of re-running the edge-cut optimizer.

    The seed is a *block list* over the same task ids (typically a
    cached winner's ``MappingSummary.block_of_task`` regrouped by
    :meth:`Scheduler.seeded`).  Downstream stages are unchanged —
    Step 2 re-prices and re-assigns the seeded blocks against the
    *actual* platform, Step 3 repairs anything that no longer fits and
    Step 4 refines — so a stale seed degrades gracefully into a
    slightly worse plan or a structured failure, never a wrong one.
    """

    name = "seed_partition"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        blocks = ctx.seed_blocks
        if blocks is None:
            raise ValueError(
                "seed_partition stage needs seed blocks "
                "(use Scheduler.seeded)"
            )
        seen: list[int] = [0] * ctx.wf.n
        for nodes in blocks:
            for u in nodes:
                if not 0 <= u < ctx.wf.n or seen[u]:
                    raise ValueError(
                        f"seed partition does not bijectively cover "
                        f"task ids 0..{ctx.wf.n - 1} (task {u})"
                    )
                seen[u] = 1
        if not all(seen):
            raise ValueError(
                f"seed partition leaves {seen.count(0)} task(s) "
                "uncovered"
            )
        ctx.blocks = [list(nodes) for nodes in blocks if nodes]


class AssignStage:
    """Step 2: BiggestAssign/FitBlock, then lift the result into a
    quotient graph + requirements cache + incremental evaluator."""

    name = "assign"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        wf, platform = ctx.wf, ctx.platform
        step2 = _biggest_assign(wf, platform, ctx.blocks,
                                ctx.exact_limit, ctx.memo)
        if not step2.assigned:
            # every block ended stuck: singletons exceeding even the
            # largest memory — report the tightest deficit
            gaps = [
                _memo_witness(wf, nodes, ctx.exact_limit, ctx.memo)[0]
                - platform.max_memory()
                for nodes in step2.unassigned
            ]
            ctx.failure = StageFailure(
                self.name,
                f"no block fits any processor at k'={ctx.k_prime}",
                min(gaps) if gaps else None,
            )
            return
        block_of: list[int] = [-1] * wf.n
        bid = 0
        proc_of_bid: dict[int, int] = {}
        for nodes, pj in step2.assigned:
            for u in nodes:
                block_of[u] = bid
            proc_of_bid[bid] = pj
            bid += 1
        for nodes in step2.unassigned:
            for u in nodes:
                block_of[u] = bid
            bid += 1
        q = build_quotient(wf, block_of)
        for vid, members in q.members.items():
            b = block_of[next(iter(members))]
            q.proc[vid] = proc_of_bid.get(b)
        ctx.q = q
        ctx.reqs = _Requirements(wf, ctx.exact_limit, sweep_memo=ctx.memo)
        ctx.ev = IncrementalEvaluator(q, platform)


class MergeStage:
    """Step 3: merge unassigned blocks into assigned ones (never moving
    pinned blocks in warm-start runs)."""

    name = "merge"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        fail = _merge_unassigned(ctx.wf, ctx.platform, ctx.q,
                                 ctx.reqs, ctx.ev, ctx.pinned)
        if fail is not None:
            ctx.failure = StageFailure(
                self.name,
                f"{fail['reason']} at k'={ctx.k_prime}",
                fail["gap"],
            )


class SwapStage:
    """Step 4a: best-improvement block swaps (pinned blocks excluded)."""

    name = "swap"
    toggle = "swap"

    def run(self, ctx: StageContext) -> None:
        _swap_pass(ctx.wf, ctx.platform, ctx.q, ctx.reqs, ctx.ev,
                   pinned=ctx.pinned)


class IdleMoveStage:
    """Step 4b: move critical-path blocks to faster idle processors
    (pinned blocks excluded)."""

    name = "idle_moves"
    toggle = "idle_moves"

    def run(self, ctx: StageContext) -> None:
        _idle_moves(ctx.wf, ctx.platform, ctx.q, ctx.reqs, ctx.ev,
                    ctx.pinned)


class WarmStartStage:
    """Warm start: rebuild the quotient from a :class:`ResumeState`
    instead of partitioning from scratch.

    Replaces Steps 1–2 in the ``warm_start`` pipeline: the inherited
    partition becomes the quotient, surviving assignments are kept
    (re-checked against their processor's memory), blocks whose
    processor disappeared re-enter Step 3 as unassigned, and pinned
    blocks are marked so merge/swap/idle_moves never move them.
    """

    name = "warm_start"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        state = ctx.resume
        if state is None:
            raise ValueError(
                "warm_start stage needs a ResumeState "
                "(use Scheduler.resume)"
            )
        wf, platform = ctx.wf, ctx.platform
        block_of: list[int] = [-1] * wf.n
        for b, nodes in enumerate(state.blocks):
            for u in nodes:
                block_of[u] = b
        if any(b < 0 for b in block_of):
            missing = block_of.count(-1)
            raise ValueError(
                f"{missing} residual task(s) not covered by any "
                "ResumeState block"
            )
        q = build_quotient(wf, block_of)
        procs_seen: dict[int, int] = {}
        for vid, members in q.members.items():
            b = block_of[next(iter(members))]
            pj = state.proc_of_block[b]
            if pj is not None and pj in procs_seen:
                raise ValueError(
                    f"processor {pj} assigned to blocks "
                    f"{procs_seen[pj]} and {b}"
                )
            if pj is not None:
                procs_seen[pj] = b
            q.proc[vid] = pj
            if b in state.pinned:
                ctx.pinned.add(vid)
        ctx.q = q
        ctx.reqs = _Requirements(wf, ctx.exact_limit, sweep_memo=ctx.memo)
        ctx.ev = IncrementalEvaluator(q, platform)
        # Re-certify kept assignments: platform events never shrink a
        # surviving processor's memory today, but hand-built states (or
        # future event kinds) may — fail structurally, not downstream.
        for vid in sorted(q.members):
            pj = q.proc[vid]
            if pj is None:
                continue
            r = ctx.reqs.of(q, vid)
            cap = platform.memory(pj)
            if r > cap * (1 + 1e-9):
                ctx.failure = StageFailure(
                    self.name,
                    f"inherited block {vid} (requirement {r:.4g}) no "
                    f"longer fits processor {pj} ({cap:.4g})",
                    r - cap,
                )
                return


class PackStage:
    """DagHetMem (§4.1): min-peak traversal packed memory-first."""

    name = "pack"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        res, fail = _pack_min_peak(ctx.wf, ctx.platform)
        if res is None:
            ctx.failure = StageFailure(self.name, fail["reason"],
                                       fail["gap"])
        else:
            ctx.result = res


def _materialize_result(ctx: StageContext, kp: int | None) -> None:
    """Lift a successful heuristic run's evaluator state into a
    :class:`MappingResult` (idempotent; ``pack`` sets ``ctx.result``
    itself).  A quotient with unassigned blocks — possible when a
    pipeline omits the merge stage, e.g. the no-replan baseline on a
    failure event — is a structured failure, never an invalid result."""
    if ctx.result is not None or ctx.failure is not None or ctx.ev is None:
        return
    unassigned = sum(1 for v in ctx.q.members if ctx.q.proc[v] is None)
    if unassigned:
        ctx.failure = StageFailure(
            "materialize",
            f"{unassigned} block(s) left unassigned by the pipeline",
            None,
        )
        return
    ms = ctx.ev.makespan()
    ctx.result = MappingResult(
        algo="DagHetPart-warm" if ctx.resume is not None else "DagHetPart",
        quotient=ctx.q,
        platform=ctx.platform,
        makespan=ms,
        runtime_s=0.0,
        k_used=ctx.q.n_vertices,
        # witness traversals double as feasibility certificates for
        # composed (bound-priced) blocks during validation
        extras={"k_prime": kp,
                "orders": ctx.reqs.witness_orders(ctx.q)},
    )


class SimulateStage:
    """Post-pipeline replay: attach a :class:`repro_torch.sim.SimReport` to
    the mapping (``extras["sim"]``).  Off by default
    (``SchedulerConfig(simulate=True)`` enables it); runs once per
    sweep point, so enable it together with a narrow k' sweep or read
    ``ScheduleReport.sim`` for the winner only.  Options come from
    ``SchedulerConfig.sim_options`` (``comm``, ``jitter``, ...)."""

    name = "simulate"
    toggle = "simulate"

    def run(self, ctx: StageContext) -> None:
        _materialize_result(ctx, ctx.k_prime)
        if ctx.result is None:
            return
        from repro_torch import sim  # deferred: core must not require sim

        ctx.result.extras["sim"] = sim.simulate(
            ctx.result, ctx.platform, **(ctx.sim_options or {}))


class ThroughputStage:
    """Post-pipeline steady-state throughput analysis
    (:mod:`repro_torch.throughput`): replicate the mapped block groups onto
    idle processors and price the sustainable instance rate
    (``extras["throughput"]``, a
    :class:`~repro_torch.throughput.ThroughputPlan`).

    Options come from ``SchedulerConfig.throughput_options``
    (``max_replicas``, ``include_comm``, ``latency_bound``).  A
    ``latency_bound`` the *unreplicated* plan already violates is a
    structured :class:`StageFailure` — the k' attempt is infeasible for
    sustained traffic even though a one-shot mapping exists, which is
    exactly how the sweep optimizes replication count and k' jointly.
    Each attempt's rate/replica-count/period land as single-observation
    histograms in the sweep point's ``metrics`` block (histogram deltas
    are always present, unlike unchanged gauges), so rate-maximizing
    selection (:func:`repro_torch.throughput.plan_throughput`) can read them
    per k'.
    """

    name = "throughput"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        _materialize_result(ctx, ctx.k_prime)
        if ctx.result is None:
            return
        from repro_torch import throughput as _tp  # deferred, like simulate

        opts = dict(ctx.throughput_options or {})
        plan = _tp.replicate_plan(ctx.result, ctx.platform, **opts)
        bound = opts.get("latency_bound")
        if bound is not None and plan.groups[0].latency > bound:
            ctx.failure = StageFailure(
                self.name,
                f"per-instance latency {plan.groups[0].latency:.6g} "
                f"exceeds bound {bound:.6g} at k'={ctx.k_prime}",
                None,
            )
            ctx.result = None
            return
        ctx.result.extras["throughput"] = plan
        METRICS.observe("throughput_rate", plan.rate)
        METRICS.observe("throughput_replicas", float(plan.n_replicas))
        METRICS.observe("throughput_period", plan.period)


class ReliabilityStage:
    """Reliability-weighted makespan pricing (:mod:`repro_torch.objectives`):
    success probability of the mapped schedule from per-block exposure
    time × its processor's exponential failure rate
    (``extras["reliability"]``, a
    :class:`~repro_torch.objectives.ReliabilityReport`).

    **Bit-inert** without a failure model: when
    ``platform.failure_rates`` is empty the stage returns without
    touching the result, so the makespan pipeline's output is
    unchanged.  Each attempt's weighted makespan / success probability
    land as single-observation histograms in the sweep point's
    ``metrics`` block (same contract as the throughput stage), so
    :func:`repro_torch.objectives.plan_reliability` can pick the
    weighted-makespan winner per k'.
    """

    name = "reliability"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        _materialize_result(ctx, ctx.k_prime)
        if ctx.result is None:
            return
        if not ctx.platform.failure_rates:
            return  # no model -> bit-inert
        from repro_torch import objectives as _obj  # deferred, like simulate

        rel = _obj.schedule_reliability(ctx.result, ctx.platform)
        ctx.result.extras["reliability"] = rel
        METRICS.counter("objective_reliability_evals")
        METRICS.observe("objective_rel_weighted_ms", rel.weighted_makespan)
        METRICS.observe("objective_success_prob", rel.success_prob,
                        boundaries=RATIO_BOUNDARIES)


class EnergyStage:
    """Energy minimization under a reliability floor
    (:mod:`repro_torch.objectives`): per-block DVFS speed choice minimizing
    static+dynamic energy while keeping the schedule's success
    probability above ``objective_options["reliability_floor"]``
    (``extras["energy"]``, an :class:`~repro_torch.objectives.EnergyReport`).

    Options come from ``SchedulerConfig.objective_options``
    (``reliability_floor``, ``speed_levels``).  A floor the all-nominal
    plan cannot reach is a structured :class:`StageFailure` with stage
    name ``"objective"`` — the k' attempt is infeasible under the
    reliability constraint even though a mapping exists.  **Bit-inert**
    without a power model (``platform.power`` empty).  The attempt's
    total energy lands as a single-observation histogram so
    :func:`repro_torch.objectives.plan_energy` can pick the energy-minimizing
    attempt per k'.
    """

    name = "energy"
    toggle = None

    def run(self, ctx: StageContext) -> None:
        _materialize_result(ctx, ctx.k_prime)
        if ctx.result is None:
            return
        if not ctx.platform.power:
            return  # no model -> bit-inert
        from repro_torch import objectives as _obj  # deferred, like simulate

        opts = dict(ctx.objective_options or {})
        floor = opts.get("reliability_floor")
        levels = opts.get("speed_levels", (1.0,))
        plan = _obj.energy_plan(ctx.result, ctx.platform,
                                reliability_floor=floor,
                                speed_levels=levels)
        if plan is None:
            METRICS.counter("objective_energy_infeasible")
            ctx.failure = StageFailure(
                "objective",
                f"reliability floor {floor:.6g} unreachable at "
                f"k'={ctx.k_prime}: even all-nominal speeds miss it",
                None,
            )
            ctx.result = None
            return
        ctx.result.extras["energy"] = plan
        METRICS.counter("objective_energy_evals")
        METRICS.observe("objective_energy_total", plan.total)
        METRICS.observe("objective_success_prob", plan.reliability,
                        boundaries=RATIO_BOUNDARIES)


_STAGES: dict[str, Stage] = {}

#: algorithm name -> pipeline (tuple of registered stage names)
PIPELINES: dict[str, tuple[str, ...]] = {}


def register_stage(stage: Stage, *, replace_existing: bool = False) -> None:
    """Register ``stage`` under ``stage.name`` for use in pipelines."""
    if stage.name in _STAGES and not replace_existing:
        raise ValueError(f"stage {stage.name!r} already registered")
    _STAGES[stage.name] = stage


def get_stage(name: str) -> Stage:
    try:
        return _STAGES[name]
    except KeyError:
        raise KeyError(
            f"unknown stage {name!r}; registered: {available_stages()}"
        ) from None


def available_stages() -> list[str]:
    return sorted(_STAGES)


def register_pipeline(algorithm: str, stage_names: Sequence[str]) -> None:
    """Register (or override) an algorithm as a stage pipeline."""
    for n in stage_names:
        get_stage(n)  # fail fast on unknown stages
    PIPELINES[algorithm] = tuple(stage_names)


for _stage in (PartitionStage(), AssignStage(), MergeStage(),
               SwapStage(), IdleMoveStage(), PackStage(),
               SimulateStage(), WarmStartStage(), SeedPartitionStage(),
               ThroughputStage(), ReliabilityStage(), EnergyStage()):
    register_stage(_stage)
register_pipeline("dag_het_part",
                  ("partition", "assign", "merge", "swap", "idle_moves",
                   "simulate"))
register_pipeline("dag_het_mem", ("pack", "simulate"))
# Scheduler.resume: inherit the partition, repair, refine.
register_pipeline("warm_start",
                  ("warm_start", "merge", "swap", "idle_moves",
                   "simulate"))
# Scheduler.seeded: adopt a cached partition, then Steps 2-4 as usual.
register_pipeline("seeded",
                  ("seed_partition", "assign", "merge", "swap",
                   "idle_moves", "simulate"))
# Sustained-traffic planning: the four-step heuristic plus steady-state
# replication/rate analysis per k' (repro_torch.throughput reads the per-point
# rate metrics to pick the rate-maximizing attempt).
register_pipeline("throughput",
                  ("partition", "assign", "merge", "swap", "idle_moves",
                   "simulate", "throughput"))
# Plan-cache hits of the sustained path: seeded Steps 2-4, same analysis.
register_pipeline("throughput_seeded",
                  ("seed_partition", "assign", "merge", "swap",
                   "idle_moves", "simulate", "throughput"))
# Richer objectives (repro_torch.objectives): the four-step heuristic plus
# reliability-weighted makespan pricing / DVFS energy minimization under
# a reliability floor per k' (both bit-inert on model-free platforms).
register_pipeline("reliability",
                  ("partition", "assign", "merge", "swap", "idle_moves",
                   "simulate", "reliability"))
register_pipeline("energy",
                  ("partition", "assign", "merge", "swap", "idle_moves",
                   "simulate", "energy"))


# ---------------------------------------------------------------------- #
# configuration
# ---------------------------------------------------------------------- #
@dataclass
class SchedulerConfig:
    """Everything a :class:`Scheduler` run is driven by.

    ``kprime`` is a sweep policy name (``"auto"`` / ``"full"``, see
    :func:`kprime_sweep_values`) or an explicit list of k' values.
    ``swap`` / ``idle_moves`` toggle the Step-4 refinement stages.
    ``time_budget_s`` soft-bounds the sweep: at least one k' always
    completes, later ones are skipped (serial) or cancelled (parallel)
    once the budget is exceeded, and the report is marked
    ``truncated``.  ``workers > 1`` runs independent k' values on a
    process pool with per-worker Step-2 memos — best makespans are
    bit-identical to serial.  ``on_sweep_result`` receives every
    :class:`SweepPoint` in sweep order, in the parent process, in both
    execution modes — ``verbose`` merely installs a default printer on
    the same channel.  ``stages`` overrides the algorithm's registered
    pipeline with an explicit stage-name sequence.  ``simulate``
    enables the post-pipeline discrete-event replay stage
    (:mod:`repro_torch.sim`), configured by the ``sim_options`` keyword dict
    (``comm``, ``jitter``, ``replicas``, ``memory``, ...); it runs once
    per sweep point and attaches a :class:`repro_torch.sim.SimReport` to
    each mapping's ``extras["sim"]`` — read ``ScheduleReport.sim`` for
    the winner's.  ``obs`` is the run's
    :class:`~repro_torch.obs.ObsConfig`: ``enabled`` turns on span tracing
    (run → sweep point → stage, incl. pool workers), ``trace_path`` /
    ``sink`` export a Chrome trace / JSONL span log at the end of the
    run — all provably inert (bit-identical makespans on/off).
    """

    algorithm: str = "dag_het_part"
    kprime: str | Sequence[int] = "auto"
    exact_limit: int = 0
    swap: bool = True
    idle_moves: bool = True
    time_budget_s: float | None = None
    workers: int = 1
    verbose: bool = False
    on_sweep_result: Callable[[SweepPoint], None] | None = None
    stages: Sequence[str] | None = None
    simulate: bool = False
    sim_options: dict | None = None
    #: keyword dict for the ``throughput`` stage (``max_replicas``,
    #: ``include_comm``, ``latency_bound``); only algorithms whose
    #: pipeline includes the stage (``throughput`` /
    #: ``throughput_seeded``) read it
    throughput_options: dict | None = None
    #: keyword dict for the objective stages (``reliability_floor``,
    #: ``speed_levels``); only algorithms whose pipeline includes the
    #: ``reliability`` / ``energy`` stage read it
    objective_options: dict | None = None
    obs: ObsConfig | None = None
    #: opt into multilevel Step-1 partitioning (coarsen → partition →
    #: uncoarsen).  Changes cuts — hence makespans — by design, so it is
    #: never on implicitly; the bit-identical scalar/flat dispatch knob
    #: lives in :func:`repro_torch.core.partitioner.set_step1_impl` instead.
    step1_multilevel: bool = False


@dataclass(frozen=True)
class _RunSpec:
    """The picklable subset of the config a worker needs.

    ``step2_impl`` / ``step1_impl`` snapshot the process-global
    dispatch modes (:func:`repro_torch.core.memdag.set_step2_impl`,
    :func:`repro_torch.core.partitioner.set_step1_impl`) at spec-creation
    time so spawn-based worker pools (no fork: the globals would reset
    to "auto" on re-import) honour a forced mode too;
    ``step1_multilevel`` carries the config's multilevel Step-1 opt-in
    into every pipeline run the same way.  ``obs_enabled`` /
    ``probe_spans`` tell spawn-pool workers to trace their sweep-point
    runs (fork workers would inherit the active tracer, but a fresh
    per-task tracer keeps the shipped span batches self-contained in
    both start methods).
    """

    stage_names: tuple[str, ...]
    exact_limit: int
    sim_options: dict | None = None
    throughput_options: dict | None = None
    objective_options: dict | None = None
    step2_impl: str = "auto"
    step1_impl: str = "auto"
    step1_multilevel: bool = False
    obs_enabled: bool = False
    probe_spans: bool = False


# ---------------------------------------------------------------------- #
# observability plumbing
# ---------------------------------------------------------------------- #
def _merge_metric_delta(acc: dict, delta: dict) -> None:
    """Fold one sweep point's sparse metrics delta (gauges + histogram
    dicts, counters excluded — they aggregate as ``cache_stats``) into
    a plain-dict accumulator of the same shape (the report's
    ``metrics`` block)."""
    for k, v in delta.get("gauges", {}).items():
        acc.setdefault("gauges", {})[k] = v
    for k, d in delta.get("histograms", {}).items():
        hists = acc.setdefault("histograms", {})
        if k not in hists:
            hists[k] = Histogram.from_dict(d).to_dict()  # detached copy
        else:
            h = Histogram.from_dict(hists[k])
            h.merge_dict(d)
            hists[k] = h.to_dict()


@contextmanager
def _obs_session(obs: ObsConfig | None):
    """One run's tracing session: yields ``(tracer, start_index)``.

    With tracing off — ``obs`` is ``None`` or disabled — yields
    ``(None, 0)`` and costs two attribute reads.  Otherwise an
    *enclosing* activation (the service loop traces across scheduler
    calls) is honoured and its tracer reused; only when this run owns
    the tracer are the exporters driven on exit: the Chrome trace to
    ``obs.trace_path``, span records to the ``obs.sink`` JSONL log.
    """
    if obs is None or not obs.enabled:
        yield None, 0
        return
    outer = _trc.current_tracer()
    tracer = outer if outer is not None else obs.make_tracer()
    own = outer is None
    with _trc.activate(tracer if own else None):
        start = len(tracer.spans)
        try:
            yield tracer, start
        finally:
            if own and (obs.trace_path or obs.sink):
                spans = tracer.spans[start:]
                if obs.trace_path:
                    write_chrome_trace(obs.trace_path,
                                       span_events(spans))
                if obs.sink:
                    with JsonlSink(obs.sink) as sink:
                        for s in spans:
                            sink.emit({"event": "span", **s.to_dict()})


# ---------------------------------------------------------------------- #
# pipeline execution (shared by the serial path and pool workers)
# ---------------------------------------------------------------------- #
def _execute_pipeline(
    wf: Workflow,
    platform: Platform,
    spec: _RunSpec,
    kp: int | None,
    memo: dict,
    resume: "ResumeState | None" = None,
    seed_blocks: list[list[int]] | None = None,
) -> tuple[MappingResult | None, SweepPoint]:
    t_run = time.perf_counter()
    snap = METRICS.snapshot()
    ctx = StageContext(wf=wf, platform=platform, k_prime=kp,
                       exact_limit=spec.exact_limit, memo=memo,
                       sim_options=spec.sim_options,
                       throughput_options=spec.throughput_options,
                       objective_options=spec.objective_options,
                       resume=resume,
                       step1_multilevel=spec.step1_multilevel,
                       seed_blocks=seed_blocks)
    stage_times: dict[str, float] = {}
    with trace_span("sweep_point", k_prime=kp, n_tasks=wf.n) as pt_span:
        for name in spec.stage_names:
            stage = get_stage(name)
            t0 = time.perf_counter()
            with trace_span(f"stage.{name}", k_prime=kp):
                stage.run(ctx)
            stage_times[name] = (stage_times.get(name, 0.0)
                                 + time.perf_counter() - t0)
            if ctx.failure is not None:
                break
        # heuristic pipelines leave the mapping in the evaluator state
        # (a trailing SimulateStage already materialized it when
        # enabled)
        _materialize_result(ctx, kp)
        dt = time.perf_counter() - t_run
        METRICS.observe("sched_sweep_point_s", dt)
        mdelta = METRICS.delta(snap)
        cache_stats = mdelta.pop("counters", {})
        # the sweep-point span carries its counter deltas + verdict
        pt_span.attrs.update(cache_stats)
        pt_span.attrs["feasible"] = ctx.result is not None
        if ctx.result is not None:
            pt_span.attrs["makespan"] = float(ctx.result.makespan)
    if ctx.result is not None:
        ctx.result.runtime_s = dt
        point = SweepPoint(k_prime=kp, makespan=float(ctx.result.makespan),
                           feasible=True, time_s=dt,
                           stage_times=stage_times,
                           cache_stats=cache_stats, metrics=mdelta)
    else:
        point = SweepPoint(k_prime=kp, makespan=None, feasible=False,
                           time_s=dt, stage_times=stage_times,
                           failed_stage=ctx.failure.stage,
                           fail_reason=ctx.failure.reason,
                           memory_gap=ctx.failure.gap,
                           cache_stats=cache_stats, metrics=mdelta)
    return ctx.result, point


# Pool workers hold the (wf, platform, spec) triple plus a *per-worker*
# Step-2 memo that persists across the k' tasks they serve — the
# parallel analogue of the serial path's single sweep-shared memo
# (ROADMAP perf follow-on #1).  Memo contents only cache deterministic
# pure functions, so sharing topology never changes results.
#
# On fork-capable platforms the triple is published to workers through
# inherited memory (set in the parent immediately before the fork):
# pickling a 10⁴-task adjacency into every worker via ``initargs``
# costs more than several whole sweep points.  Forking with torch loaded
# in the parent is safe *here* because workers execute only this
# pure-Python scheduling code and never call into torch (or any other
# threaded runtime) before exiting.
_WORKER_STATE: dict = {}


def _pool_init(wf: Workflow, platform: Platform, spec: _RunSpec) -> None:
    from .memdag import set_step2_impl
    from .partitioner import set_step1_impl

    _WORKER_STATE["wf"] = wf
    _WORKER_STATE["platform"] = platform
    _WORKER_STATE["spec"] = spec
    _WORKER_STATE["memo"] = {}
    set_step2_impl(spec.step2_impl)  # no-op on fork, needed on spawn
    set_step1_impl(spec.step1_impl)


def _make_pool(wf: Workflow, platform: Platform, spec: _RunSpec,
               max_workers: int) -> ProcessPoolExecutor:
    """A pool for one sweep, its workers forked from the parent as it
    stands (or spawned where ``fork`` is missing).

    The caller joins the pool before ``schedule()`` returns
    (``shutdown(wait=True)``; see ``Scheduler._run_sweep``).  A pool left
    to wind down after its sweep keeps its manager thread alive, and that
    thread takes its wakeup lock now and then; the next sweep's ``fork``
    can copy that lock held into a worker, which then blocks for good in
    ``concurrent.futures``' exit hook, and the parent blocks joining it at
    its own exit.
    """
    import multiprocessing as mp

    try:
        ctx = mp.get_context("fork")
    except ValueError:  # platform without fork (e.g. Windows)
        ctx = None
    if ctx is None:
        return ProcessPoolExecutor(
            max_workers=max_workers,
            initializer=_pool_init, initargs=(wf, platform, spec))
    # fork path: children inherit _WORKER_STATE as set right now; the
    # memo dict is fresh, and each child's copy is independent (CoW).
    # (Pre-warming the memo in the parent was measured and rejected:
    # CPython refcount writes force copy-on-write of the inherited
    # pages, costing more than the workers' cold recomputation.)
    _pool_init(wf, platform, spec)
    return ProcessPoolExecutor(max_workers=max_workers, mp_context=ctx)


def _pool_run(kp: int | None) -> tuple[MappingResult | None, SweepPoint]:
    spec = _WORKER_STATE["spec"]
    # A fresh per-task tracer (never the fork-inherited parent tracer):
    # the shipped span batch is exactly this sweep point's, and its tid
    # carries the worker pid as the track name.
    tracer = (_trc.Tracer(probe_spans=spec.probe_spans)
              if spec.obs_enabled else None)
    with _trc.activate_exclusive(tracer):
        res, point = _execute_pipeline(
            _WORKER_STATE["wf"], _WORKER_STATE["platform"],
            spec, kp, _WORKER_STATE["memo"])
    if tracer is not None:
        point.spans = tracer.spans
    if res is not None:
        # Detach the workflow before the result crosses the process
        # boundary: the parent re-attaches its own (identical) copy.
        # Pickling the full adjacency once per sweep point would
        # otherwise dominate the parallel path's wall clock.
        res.quotient.wf = None
    return res, point


# ---------------------------------------------------------------------- #
# the facade
# ---------------------------------------------------------------------- #
def _default_printer(point: SweepPoint) -> None:
    # ``verbose`` narration goes through logging (silent until the
    # application installs a handler; CLI entry points call
    # ``repro_torch.obs.setup_logging()`` for classic print-style output).
    label = f"k'={point.k_prime}" if point.k_prime is not None else "run"
    if point.feasible:
        _log.info("  %s: makespan=%.2f", label, point.makespan)
    else:
        _log.info("  %s: infeasible (%s: %s)", label,
                  point.failed_stage, point.fail_reason)


class Scheduler:
    """Facade over the stage pipelines and the k' sweep.

    >>> report = Scheduler(SchedulerConfig(kprime=[1, 4, 9])).schedule(
    ...     wf, platform)                                # doctest: +SKIP
    >>> report.feasible, report.makespan                 # doctest: +SKIP

    Construction accepts a full :class:`SchedulerConfig`, keyword
    overrides on top of it, or keywords alone.
    """

    def __init__(self, config: SchedulerConfig | None = None,
                 **overrides) -> None:
        cfg = config if config is not None else SchedulerConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
        self.config = cfg

    # -------------------------------------------------------------- #
    def _filter_toggles(self, names: Sequence[str]) -> tuple[str, ...]:
        cfg = self.config
        out = []
        for n in names:
            stage = get_stage(n)
            toggle = getattr(stage, "toggle", None)
            if toggle is not None and not getattr(cfg, toggle):
                continue
            out.append(n)
        return tuple(out)

    def stage_names(self) -> tuple[str, ...]:
        """The resolved, toggle-filtered pipeline for this config."""
        cfg = self.config
        if cfg.stages is not None:
            names: Sequence[str] = tuple(cfg.stages)
        else:
            try:
                names = PIPELINES[cfg.algorithm]
            except KeyError:
                raise ValueError(
                    f"unknown algorithm {cfg.algorithm!r}; registered "
                    f"pipelines: {sorted(PIPELINES)}"
                ) from None
        return self._filter_toggles(names)

    def sweep_values(self, wf: Workflow,
                     platform: Platform) -> list[int | None]:
        """The k' values this run will attempt (``[None]`` for
        pipelines without a partition stage — nothing to sweep)."""
        if "partition" not in self.stage_names():
            return [None]
        kprime = self.config.kprime
        if isinstance(kprime, str):
            return list(kprime_sweep_values(wf, platform, kprime))
        vals = [int(x) for x in kprime]
        if not vals:
            raise ValueError("empty k' sweep")
        return vals

    # -------------------------------------------------------------- #
    def schedule(self, wf: Workflow, platform: Platform) -> ScheduleReport:
        """Run the configured pipeline; always a :class:`ScheduleReport`."""
        cfg = self.config
        return self._with_obs(
            {"algorithm": cfg.algorithm, "n_tasks": wf.n,
             "workers": cfg.workers},
            lambda: self._run_sweep(wf, platform))

    def _with_obs(self, run_attrs: dict,
                  fn: Callable[[], ScheduleReport]) -> ScheduleReport:
        """Wrap one run in the obs session + root ``run`` span and
        attach the run's span slice to the report."""
        with _obs_session(self.config.obs) as (tracer, start):
            with trace_span("run", **run_attrs):
                report = fn()
            if tracer is not None:
                report.spans = list(tracer.spans[start:])
        return report

    def _run_sweep(self, wf: Workflow,
                   platform: Platform) -> ScheduleReport:
        """The k' sweep, serial or on a process pool (``workers > 1``).

        The pool is joined before this returns: on a normal return, after
        a ``time_budget_s`` truncation, and when a callback raises.  The
        join cancels the points not yet started and waits for those
        already running (on the exception path that is all it waits
        for), then for the workers and the pool's manager thread, so no
        process or thread of the sweep outlives it (``_make_pool`` says
        why that matters).
        """
        cfg = self.config
        t0 = time.perf_counter()
        from .memdag import step2_impl
        from .partitioner import step1_impl

        tracer = _trc.current_tracer()
        spec = _RunSpec(self.stage_names(), cfg.exact_limit,
                        cfg.sim_options, cfg.throughput_options,
                        cfg.objective_options,
                        step2_impl(), step1_impl(),
                        cfg.step1_multilevel,
                        obs_enabled=tracer is not None,
                        probe_spans=(tracer.probe_spans
                                     if tracer is not None else False))
        sweep = self.sweep_values(wf, platform)
        callbacks: list[Callable[[SweepPoint], None]] = []
        if cfg.verbose:
            callbacks.append(_default_printer)
        if cfg.on_sweep_result is not None:
            callbacks.append(cfg.on_sweep_result)

        # Best-result reduction is folded into collection: points are
        # consumed in sweep order in both modes, and strict < keeps
        # the earliest-k' winner, so at most two mappings (incumbent +
        # candidate) are ever alive — the k'-length sweep would
        # otherwise hold one full mapping per point at 30k tasks.
        best: MappingResult | None = None
        points: list[SweepPoint] = []
        truncated = False

        def reduce_best(res: MappingResult | None) -> None:
            nonlocal best
            if res is not None and (best is None
                                    or res.makespan < best.makespan):
                best = res

        def over_budget() -> bool:
            return (cfg.time_budget_s is not None
                    and time.perf_counter() - t0 > cfg.time_budget_s)

        if cfg.workers > 1 and len(sweep) > 1:
            pool = _make_pool(wf, platform, spec,
                              min(cfg.workers, len(sweep)))
            try:
                futs = [pool.submit(_pool_run, kp) for kp in sweep]
                # iterate in sweep order: callbacks and the best-result
                # reduction stay deterministic regardless of completion
                # order
                exhausted = False
                for fut in futs:
                    if points and not exhausted and over_budget():
                        exhausted = True
                    if exhausted and fut.cancel():
                        # only not-yet-started work is dropped; results
                        # already computed (or in flight) are collected
                        truncated = True
                        continue
                    res, point = fut.result()
                    if res is not None:
                        res.quotient.wf = wf  # re-attach (see _pool_run)
                    # Workers recorded into *their* registries: fold the
                    # shipped deltas into the parent's.  (Only here —
                    # the serial path records in-process directly.)
                    METRICS.merge({"counters": point.cache_stats,
                                   **point.metrics})
                    if tracer is not None and point.spans:
                        tracer.extend(point.spans)
                        point.spans = []  # spliced; avoid double export
                    reduce_best(res)
                    points.append(point)
                    for cb in callbacks:
                        cb(point)
            finally:
                pool.shutdown(wait=True, cancel_futures=True)  # see _make_pool
                _WORKER_STATE.clear()  # parent copy: drop wf references
        else:
            memo: dict = {}  # content-keyed reuse across the serial sweep
            for kp in sweep:
                if points and over_budget():
                    truncated = True
                    break
                res, point = _execute_pipeline(wf, platform, spec, kp, memo)
                reduce_best(res)
                points.append(point)
                for cb in callbacks:
                    cb(point)

        total = time.perf_counter() - t0
        stage_times: dict[str, float] = {}
        cache_stats: dict[str, int] = {}
        run_metrics: dict = {}
        for p in points:
            for name, dt in p.stage_times.items():
                stage_times[name] = stage_times.get(name, 0.0) + dt
            for name, c in p.cache_stats.items():
                cache_stats[name] = cache_stats.get(name, 0) + c
            _merge_metric_delta(run_metrics, p.metrics)

        if best is not None:
            best.runtime_s = total  # whole-sweep time, as dag_het_part did
            summary = MappingSummary.from_result(best)
            infeas = None
        else:
            summary = None
            infeas = self._diagnose(spec.stage_names, points)
        return ScheduleReport(
            algorithm=cfg.algorithm,
            summary=summary,
            infeasibility=infeas,
            sweep=points,
            stage_times=stage_times,
            total_time_s=total,
            workers=cfg.workers,
            truncated=truncated,
            cache_stats=cache_stats,
            metrics=run_metrics,
            best=best,
        )

    __call__ = schedule

    # -------------------------------------------------------------- #
    def resume(self, state: ResumeState) -> ScheduleReport:
        """Warm-start replan from a partially executed plan.

        Runs the ``warm_start`` pipeline (inherit the partition from
        ``state``, merge orphaned blocks, pin-aware Step-4 refinement;
        ``config.stages`` overrides the stage list, ``swap`` /
        ``idle_moves`` / ``simulate`` toggles apply) on the residual
        workflow.  No k' sweep: the partition already exists — that is
        what warm-starting buys over :meth:`schedule`.  Always returns
        a :class:`ScheduleReport` (``algorithm="warm_start"``); pinned
        blocks keep their processor in any feasible result.
        """
        return self._with_obs(
            {"algorithm": "warm_start", "n_tasks": state.wf.n},
            lambda: self._resume_impl(state))

    def _resume_impl(self, state: ResumeState) -> ScheduleReport:
        cfg = self.config
        t0 = time.perf_counter()
        names = self._filter_toggles(
            cfg.stages if cfg.stages is not None
            else PIPELINES["warm_start"])
        from .memdag import step2_impl
        from .partitioner import step1_impl

        spec = _RunSpec(names, cfg.exact_limit, cfg.sim_options,
                        cfg.throughput_options, cfg.objective_options,
                        step2_impl(), step1_impl(), cfg.step1_multilevel)
        res, point = _execute_pipeline(state.wf, state.platform, spec,
                                       None, {}, resume=state)
        for cb in ([_default_printer] if cfg.verbose else []) + (
                [cfg.on_sweep_result] if cfg.on_sweep_result else []):
            cb(point)
        total = time.perf_counter() - t0
        if res is not None:
            res.runtime_s = total
            summary = MappingSummary.from_result(res)
            infeas = None
        else:
            summary = None
            infeas = self._diagnose(names, [point], algorithm="warm_start")
        return ScheduleReport(
            algorithm="warm_start",
            summary=summary,
            infeasibility=infeas,
            sweep=[point],
            stage_times=dict(point.stage_times),
            total_time_s=total,
            workers=1,
            cache_stats=dict(point.cache_stats),
            metrics=dict(point.metrics),
            best=res,
        )

    # -------------------------------------------------------------- #
    def seeded(self, wf: Workflow, platform: Platform,
               block_of_task: Sequence[int],
               k_prime: int | None = None) -> ScheduleReport:
        """Plan-cache seeding hook: schedule ``wf`` starting from a
        previously computed partition instead of the k' sweep.

        ``block_of_task`` is a per-task block id (the shape stored by
        :class:`MappingSummary` — ids need not be contiguous); blocks
        are regrouped in ascending-id order and fed through the
        ``seeded`` pipeline (``seed_partition → assign → merge → swap →
        idle_moves → simulate``), so Step 2 re-prices the seed against
        the *actual* platform and Steps 3–4 repair and refine it.  No
        k' sweep — that is what a cache hit buys, exactly as
        :meth:`resume` skips it after a failure.  ``k_prime`` is
        recorded on the single :class:`SweepPoint` for diagnostics
        (conventionally the cached winner's value).  Always returns a
        :class:`ScheduleReport` (``algorithm="seeded"``); a seed that
        no longer fits is a structured infeasibility, not an error.
        """
        return self._with_obs(
            {"algorithm": "seeded", "n_tasks": wf.n},
            lambda: self._seeded_impl(wf, platform, block_of_task,
                                      k_prime))

    def _seeded_impl(self, wf: Workflow, platform: Platform,
                     block_of_task: Sequence[int],
                     k_prime: int | None) -> ScheduleReport:
        if len(block_of_task) != wf.n:
            raise ValueError(
                f"block_of_task has {len(block_of_task)} entries for "
                f"{wf.n} tasks"
            )
        groups: dict[int, list[int]] = {}
        for u, b in enumerate(block_of_task):
            groups.setdefault(int(b), []).append(u)
        seed = [groups[b] for b in sorted(groups)]
        cfg = self.config
        t0 = time.perf_counter()
        names = self._filter_toggles(
            cfg.stages if cfg.stages is not None
            else PIPELINES["seeded"])
        from .memdag import step2_impl
        from .partitioner import step1_impl

        spec = _RunSpec(names, cfg.exact_limit, cfg.sim_options,
                        cfg.throughput_options, cfg.objective_options,
                        step2_impl(), step1_impl(), cfg.step1_multilevel)
        res, point = _execute_pipeline(wf, platform, spec,
                                       k_prime, {}, seed_blocks=seed)
        for cb in ([_default_printer] if cfg.verbose else []) + (
                [cfg.on_sweep_result] if cfg.on_sweep_result else []):
            cb(point)
        total = time.perf_counter() - t0
        if res is not None:
            res.runtime_s = total
            summary = MappingSummary.from_result(res)
            infeas = None
        else:
            summary = None
            infeas = self._diagnose(names, [point], algorithm="seeded")
        return ScheduleReport(
            algorithm="seeded",
            summary=summary,
            infeasibility=infeas,
            sweep=[point],
            stage_times=dict(point.stage_times),
            total_time_s=total,
            workers=1,
            cache_stats=dict(point.cache_stats),
            metrics=dict(point.metrics),
            best=res,
        )

    # -------------------------------------------------------------- #
    def _diagnose(self, stage_names: tuple[str, ...],
                  points: list[SweepPoint],
                  algorithm: str | None = None) -> Infeasibility:
        order = {name: i for i, name in enumerate(stage_names)}
        furthest = max(points,
                       key=lambda p: order.get(p.failed_stage, -1))
        gaps = [p.memory_gap for p in points
                if p.memory_gap is not None and p.memory_gap > 0]
        kps = [p.k_prime for p in points if p.k_prime is not None]
        return Infeasibility(
            algorithm=algorithm or self.config.algorithm,
            stage=furthest.failed_stage or "?",
            reason=furthest.fail_reason or "no sweep value succeeded",
            tightest_gap=min(gaps) if gaps else None,
            smallest_kprime=min(kps) if kps else None,
            attempts=len(points),
        )


def schedule(wf: Workflow, platform: Platform,
             config: SchedulerConfig | None = None,
             **overrides) -> ScheduleReport:
    """One-call convenience: ``Scheduler(config, **kw).schedule(...)``.

    Keyword overrides are :class:`SchedulerConfig` fields — commonly
    ``algorithm=``, ``kprime=``, ``workers=``, ``simulate=`` and
    ``sim_options=`` (the keyword dict handed to the simulate stage:
    ``comm=``, ``jitter=``, ``replicas=``, ``memory=``, ...)::

        schedule(wf, platform, simulate=True,
                 sim_options={"comm": "fair-share"}).sim
    """
    return Scheduler(config, **overrides).schedule(wf, platform)
