"""Time-resolved memory-occupancy tracking of a simulated schedule.

The analytic pipeline certifies memory feasibility through *block
sums*: the minimum (or witnessed) traversal peak of every block fits
its processor.  Feasibility of the actual execution, though, is a
property of the **schedule trace** — at every instant, the files live
on a processor plus the running task's footprint must fit (cf.
Eyraud-Dubois et al., "Parallel scheduling of task trees with limited
memory").  This module replays each block's sequential task order
inside its simulated compute interval and builds the occupancy step
function, flagging the exact time/processor/task of any transient
violation.

Memory model — identical to :mod:`repro_torch.core.memdag` (the block
requirement is its traversal peak plus the persistent base):

* while task ``u`` runs, occupancy is ``persistent base + live internal
  files + ext_in(u) + m_u + out_total(u)``;
* between tasks, occupancy is the base plus the live internal files;
* transfers do not add occupancy of their own: an external input
  materializes when its consumer starts and an external output is
  freed when its producer completes, exactly as priced by
  ``block_requirement`` — so a mapping whose blocks fit is violation-
  free in the trace *for the same traversal order*.

The replayed order per block is the planner's witness
(``MappingResult.extras["orders"]``) when present and valid — the order
execution would actually use — falling back to the greedy min-peak
traversal otherwise.  A block whose *witness* order overflows while a
better traversal exists is precisely the "block sums pass, trace
violates" case this tracker exists to expose.
"""
from __future__ import annotations

from repro_torch.core.dag import QuotientGraph, Workflow
from repro_torch.core.memdag import greedy_min_peak_members, occupancy_steps
from repro_torch.core.platform import Platform

from .report import MemoryTrace, MemoryViolation

__all__ = ["build_memory_trace", "pick_block_order"]

#: relative slack mirroring validate_mapping's float tolerance
_TOL = 1 + 1e-9


def _witness_valid(wf: Workflow, members: set[int], order) -> bool:
    if order is None or set(order) != members or len(order) != len(members):
        return False
    done: set[int] = set()
    for u in order:
        if any(p in members and p not in done for p in wf.pred[u]):
            return False
        done.add(u)
    return True


def pick_block_order(wf: Workflow, members: set[int],
                     witness=None) -> list[int]:
    """The traversal the trace replays: valid witness, else greedy."""
    if _witness_valid(wf, members, witness):
        return list(witness)
    _, order = greedy_min_peak_members(wf, sorted(members))
    return order


def build_memory_trace(
    wf: Workflow,
    q: QuotientGraph,
    platform: Platform,
    start: dict[int, float],
    finish: dict[int, float],
    orders: dict[int, list[int]] | None = None,
    *,
    violation_limit: int = 64,
) -> MemoryTrace:
    """Occupancy step functions + violations for a simulated schedule.

    ``start`` / ``finish`` are the engine's block intervals; member
    tasks are laid out sequentially from ``start[vid]`` with durations
    ``w_u / s_p``.  Occupancies come from the shared
    :func:`repro_torch.core.memdag.occupancy_steps` accumulation, so peaks
    are bit-identical to ``base + simulate_peak_members(wf, members,
    order)`` (float rounding is monotone under the constant shift).
    """
    orders = orders or {}
    per_proc: dict[int, list[tuple[float, float]]] = {}
    peak: dict[int, float] = {}
    violations: list[MemoryViolation] = []

    for vid in sorted(q.members):
        members = q.members[vid]
        p = q.proc[vid]
        if p is None:
            raise ValueError(f"block {vid} has no processor")
        cap = platform.memory(p)
        speed = platform.procs[p].speed
        order = pick_block_order(wf, members, orders.get(vid))
        base = sum(wf.persistent[u] for u in members)
        points = per_proc.setdefault(p, [])
        t = start[vid]
        points.append((t, base))
        blk_peak = base
        for u, during, live_after in occupancy_steps(wf, members, order):
            occ = base + during
            points.append((t, occ))
            if occ > blk_peak:
                blk_peak = occ
            if occ > cap * _TOL and len(violations) < violation_limit:
                violations.append(MemoryViolation(
                    time=t, proc=p, vertex=vid, task=u,
                    occupancy=occ, capacity=cap))
            t = t + wf.work[u] / speed
            points.append((t, base + live_after))
        points.append((finish[vid], 0.0))
        if blk_peak > peak.get(p, 0.0):
            peak[p] = blk_peak

    for pts in per_proc.values():
        pts.sort(key=lambda x: x[0])
    violations.sort(key=lambda v: (v.time, v.proc, v.task))
    return MemoryTrace(per_proc=per_proc, peak=peak, violations=violations)
