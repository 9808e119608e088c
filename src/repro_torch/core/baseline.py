"""DagHetMem — the memory-aware baseline (paper §4.1).

Builds directly on the MemDag-style traversal: compute a (near)
minimum-peak-memory order of the *entire* workflow, then pack tasks in
that order onto processors sorted by decreasing memory, closing a block
whenever the next task would overflow the current processor.

The baseline ignores processor speeds and DAG parallelism — it exists to
produce *valid* mappings (memory constraints respected) against which
the four-step heuristic is measured.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

from .dag import QuotientGraph, Workflow, build_quotient
from .makespan import makespan as compute_makespan
from .memdag import greedy_min_peak
from .platform import Platform

__all__ = ["MappingResult", "dag_het_mem", "validate_mapping"]


@dataclass
class MappingResult:
    """A valid solution of DAGP-PM: partition + processor mapping."""

    algo: str
    quotient: QuotientGraph
    platform: Platform
    makespan: float
    runtime_s: float
    k_used: int
    extras: dict = field(default_factory=dict)

    def block_of_task(self) -> list[int]:
        arr = self.quotient.assignment_array()
        return [int(x) for x in arr]


def dag_het_mem(wf: Workflow, platform: Platform) -> MappingResult | None:
    """Memory-first greedy packing along a min-peak traversal.

    .. deprecated::
        Use :class:`repro_torch.core.scheduler.Scheduler` with
        ``algorithm="dag_het_mem"`` (or ``schedule(wf, platform,
        algorithm="dag_het_mem")``), which returns a
        :class:`~repro_torch.core.scheduler.ScheduleReport` — never ``None``
        — with stage timings and a structured infeasibility diagnosis.
        This wrapper keeps the old ``MappingResult | None`` contract by
        returning ``report.best``.
    """
    warnings.warn(
        "dag_het_mem() is deprecated; use repro_torch.core.scheduler."
        "Scheduler with algorithm='dag_het_mem' (returns a "
        "ScheduleReport instead of MappingResult | None)",
        DeprecationWarning, stacklevel=2,
    )
    from .scheduler import schedule

    return schedule(wf, platform, algorithm="dag_het_mem").best


def _pack_min_peak(
    wf: Workflow, platform: Platform
) -> tuple[MappingResult | None, dict | None]:
    """The DagHetMem packing itself: ``(result, failure)``.

    Exactly one of the pair is non-``None``.  ``failure`` carries
    ``{"reason", "gap"}``: ``gap`` is the deficit (requirement minus
    capacity) of the single task that broke the packing when that task
    alone cannot fit — ``None`` when the shortfall is aggregate (the
    platform's total memory ran out) rather than per-block.  The paper's
    reading of either case: "the workflow needs a larger platform".
    """
    t0 = time.perf_counter()
    if wf.n == 0:
        raise ValueError("empty workflow")

    _, order = greedy_min_peak(wf, return_order=True)
    proc_order = platform.sorted_by_memory()

    block_of = [-1] * wf.n
    blocks_procs: list[int] = []   # processor of block i
    cur_block = 0
    cur_count = 0                  # tasks in the current block
    cur_proc_idx = 0               # index into proc_order
    cap = platform.memory(proc_order[0])
    live: dict[tuple[int, int], float] = {}  # in-block files -> cost
    live_total = 0.0
    block_peak = 0.0

    persist = 0.0
    i = 0
    while i < wf.n:
        u = order[i]
        # inputs produced inside the current block are already live;
        # inputs from earlier (closed) blocks stream in on demand.
        ext_in = sum(
            c for p, c in wf.pred[u].items() if (p, u) not in live
        )
        # persistent residency (placement layer) is held for the whole
        # block execution, so the block requirement is Σ persistent +
        # the transient traversal peak — block_peak tracks transients
        during = live_total + ext_in + wf.mem[u] + wf.out_cost(u)
        peak_cand = max(block_peak, during)
        if peak_cand + persist + wf.persistent[u] <= cap:
            block_of[u] = cur_block
            persist += wf.persistent[u]
            for p in wf.pred[u]:
                c = live.pop((p, u), None)
                if c is not None:
                    live_total -= c
            for v, c in wf.succ[u].items():
                live[(u, v)] = c
                live_total += c
            block_peak = peak_cand
            cur_count += 1
            i += 1
            continue
        # close the current block (if non-empty) and move to next proc
        if cur_count > 0:
            blocks_procs.append(proc_order[cur_proc_idx])
            cur_block += 1
            cur_count = 0
        cur_proc_idx += 1
        single = (wf.persistent[u] + wf.mem[u] + wf.in_cost(u)
                  + wf.out_cost(u))
        if cur_proc_idx >= platform.k:
            # not enough memory in the platform
            gap = single - platform.max_memory()
            return None, {
                "reason": (
                    f"all {platform.k} processors exhausted with "
                    f"{wf.n - i} of {wf.n} tasks unpacked"
                ),
                "gap": gap if gap > 0 else None,
            }
        cap = platform.memory(proc_order[cur_proc_idx])
        live = {}
        live_total = 0.0
        block_peak = 0.0
        persist = 0.0
        # Guard: task alone exceeding every remaining (smaller) memory
        if single > cap:
            return None, {
                "reason": (
                    f"task {u} needs {single:.4g} alone, more than any "
                    f"remaining processor memory ({cap:.4g})"
                ),
                "gap": single - cap,
            }
    blocks_procs.append(proc_order[cur_proc_idx])

    q = build_quotient(wf, block_of)
    # build_quotient numbers vertices by smallest member; recover the
    # traversal block ids to attach processors.
    vid_by_block: dict[int, int] = {}
    for vid, members in q.members.items():
        b = block_of[next(iter(members))]
        vid_by_block[b] = vid
    for b, pj in enumerate(blocks_procs):
        q.proc[vid_by_block[b]] = pj
    # Retain the packing traversal per block: it is a *witness* that the
    # block fits its processor (the greedy re-derivation in validation
    # may find a worse order).
    orders: dict[int, list[int]] = {vid: [] for vid in q.members}
    for u in order:
        orders[vid_by_block[block_of[u]]].append(u)
    if not q.is_acyclic():
        # The traversal order is topological, and blocks are contiguous
        # in it, so this cannot happen; keep as a hard invariant.
        raise AssertionError("baseline produced a cyclic quotient graph")
    ms = compute_makespan(q, platform)
    return MappingResult(
        algo="DagHetMem",
        quotient=q,
        platform=platform,
        makespan=ms,
        runtime_s=time.perf_counter() - t0,
        k_used=len(blocks_procs),
        extras={"orders": orders},
    ), None


def validate_mapping(
    wf: Workflow,
    result: MappingResult,
    *,
    exact_limit: int = 0,
    memory_trace: bool = False,
) -> list[str]:
    """Check all DAGP-PM constraints; returns a list of violations.

    * every task in exactly one block,
    * acyclic quotient graph,
    * injective block→processor mapping,
    * every block's memory requirement within its processor's memory.

    ``memory_trace=True`` additionally replays the schedule through the
    simulator's memory tracker (:mod:`repro_torch.sim`) and reports every
    *transient* violation with its first time-point and processor.
    Block sums are priced with the best traversal known (min of witness
    and greedy re-derivation), while the trace replays the traversal
    execution would actually use — so a plan whose witness order
    overflows is caught here even when a better traversal makes the
    block sum pass.  Trace checking requires the structural constraints
    to hold and is skipped (with a note) when they do not.

    ``r_{V_i}`` is the *minimum* peak over traversals; any witness order
    (e.g. the baseline's packing traversal or the heuristic's composed
    merge witnesses, stored in ``result.extras["orders"]``) upper-bounds
    it.  The witness is simulated *first* — when it already proves the
    fit, the much costlier greedy re-derivation is skipped entirely,
    which keeps validation affordable at 30k tasks.
    """
    from .memdag import block_requirement, simulate_peak_members

    errors: list[str] = []
    simulable = True  # trace needs an acyclic, fully assigned quotient
    q = result.quotient
    covered: set[int] = set()
    for vid, members in q.members.items():
        dup = covered & members
        if dup:
            errors.append(f"tasks {sorted(dup)[:5]} in multiple blocks")
        covered |= members
    if covered != set(range(wf.n)):
        errors.append(
            f"{wf.n - len(covered)} tasks not covered by any block"
        )
    if not q.is_acyclic():
        errors.append("quotient graph is cyclic")
        simulable = False
    used: dict[int, int] = {}
    for vid in q.vertices():
        pj = q.proc[vid]
        if pj is None:
            errors.append(f"block {vid} unassigned")
            simulable = False
            continue
        if pj in used:
            errors.append(f"processor {pj} used by blocks {used[pj]} and {vid}")
        used[pj] = vid
        members = q.members[vid]
        cap = result.platform.memory(pj)
        witness = result.extras.get("orders", {}).get(vid)
        r = None
        if witness is not None and set(witness) == members:
            done: set[int] = set()
            valid = True
            for u in witness:
                if any(p in members and p not in done
                       for p in wf.pred[u]):
                    valid = False
                    break
                done.add(u)
            if valid:
                base = sum(wf.persistent[u] for u in members)
                r = base + simulate_peak_members(wf, members, witness)
        if r is None or r > cap:
            r_greedy = block_requirement(wf, sorted(members),
                                         exact_limit=exact_limit)
            r = r_greedy if r is None else min(r, r_greedy)
        if r > cap * (1 + 1e-9):
            errors.append(
                f"block {vid}: requirement {r:.3f} exceeds memory "
                f"{cap:.3f} of processor {pj}"
            )
    if memory_trace:
        if not simulable:
            errors.append(
                "memory trace skipped: quotient not simulable "
                "(cyclic or unassigned blocks)"
            )
        else:
            # deferred import: sim builds on core
            from repro_torch.sim import trace_memory

            trace = trace_memory(result, result.platform)
            for v in trace.violations:
                errors.append(
                    f"transient memory violation at t={v.time:.6g} on "
                    f"processor {v.proc} (block {v.vertex}, task "
                    f"{v.task}): occupancy {v.occupancy:.6g} exceeds "
                    f"memory {v.capacity:.6g}"
                )
    return errors
