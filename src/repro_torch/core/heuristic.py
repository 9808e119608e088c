"""DagHetPart — the four-step partitioning-based heuristic (paper §4.2).

Step 1  Partition the DAG into k' acyclic blocks (edge-cut optimizer).
Step 2  BiggestAssign/FitBlock: largest block → largest-memory free
        processor; blocks that do not fit are recursively split.
Step 3  MergeUnassignedToAssigned/FindMSOptMerge: merge leftover blocks
        into assigned ones, preferring merges off the critical path,
        resolving 2-cycles by triple merges, bounded re-queuing.
Step 4  Swaps: best-improvement block swaps + moves of critical-path
        blocks to faster idle processors.

The sweep tries every k' ≤ k and keeps the best makespan (paper Step 1).

Migration note
--------------
The pipeline itself now lives in :mod:`repro_torch.core.scheduler`: Steps 1–4
are registered, composable pipeline stages (``"partition"``,
``"assign"``, ``"merge"``, ``"swap"``, ``"idle_moves"``) driven by a
:class:`~repro_torch.core.scheduler.Scheduler`, which also parallelizes the
k' sweep and returns structured :class:`ScheduleReport`\\ s.  This
module keeps the step *implementations* plus a deprecated
:func:`dag_het_part` wrapper for the old ``MappingResult | None``
contract.

Scaling design (30k-task instances)
-----------------------------------
Candidate evaluation no longer re-sweeps Γ: Steps 3–4 share one
:class:`repro_torch.core.incremental.IncrementalEvaluator`, which maintains
bottom weights / makespan / critical path under merges, reassignments
and swaps via ancestor-only delta propagation with transactional
rollback.  Block memory requirements come from :class:`_Requirements`,
an LRU-bounded cache that *composes* merged requirements from part
witnesses (``r(A∪B) ≤ base_A + base_B + max(peak_A, peak_B) + X`` for a
one-directional merge with cross volume ``X``; ``r(A∪B) ≥ max(r_A,
r_B)``) so most merge candidates are priced O(1) instead of re-running
the min-peak traversal search.  Step 4 prunes the O(V²) swap scan to
pairs touching the critical path — a swap leaving every current
maximum chain untouched cannot lower the makespan — with an optional
exhaustive verification scan after convergence.

Three further layers make 30k-task instances routine (see
``docs/architecture.md``): Step 2's block constants and ready-heap run
on flat numpy arrays (:mod:`repro_torch.core.memdag`, bit-identical to the
scalar path); committed merges maintain topological ranks via
Pearce–Kelly localized reordering with a rank-window-bounded
acyclicity probe (:class:`IncrementalEvaluator`); and Step-4 rescans
reuse probe verdicts whose dependency region the applied swap did not
touch (see :func:`_swap_pass`).  Step 1 follows the same way: refinement
replays the scalar move sequence over the same cached CSR view behind
a vectorized prefilter, with an opt-in multilevel
coarsen→partition→uncoarsen mode for n ≥ 100k
(:mod:`repro_torch.core.partitioner`).  All are observable through
``ScheduleReport.cache_stats``.
"""
from __future__ import annotations

import heapq
import itertools
import warnings
from collections import OrderedDict, deque
from dataclasses import dataclass

from . import counters
from .baseline import MappingResult
from .dag import QuotientGraph, Workflow
from .incremental import IncrementalEvaluator
from .memdag import block_requirement_witness, simulate_peak_members
from .partitioner import partition_block
from .platform import Platform

__all__ = ["dag_het_part", "kprime_sweep_values"]


# ---------------------------------------------------------------------- #
# Step 2: BiggestAssign + FitBlock (Algorithms 1–2)
# ---------------------------------------------------------------------- #
@dataclass
class _Step2Result:
    assigned: list[tuple[list[int], int]]  # (tasks, processor)
    unassigned: list[list[int]]


class _BlockPQ:
    """Max-priority queue of blocks keyed by memory requirement.

    ``memo`` (shared across the k' sweep) deduplicates requirement
    computations: FitBlock's recursive bisection revisits the same
    blocks for different k' — e.g. k'=1's first split of the full task
    set is exactly k'=2's initial partition — so content-keyed reuse
    cuts most of Step 2's traversal-search work after the first k'.
    """

    def __init__(self, wf: Workflow, exact_limit: int,
                 memo: dict | None = None) -> None:
        self.wf = wf
        self.exact_limit = exact_limit
        self.memo = memo if memo is not None else {}
        self._heap: list[tuple[float, int, list[int]]] = []
        self._counter = itertools.count()

    def requirement(self, nodes: list[int]) -> float:
        return _memo_witness(self.wf, nodes, self.exact_limit,
                             self.memo)[0]

    def push(self, nodes: list[int]) -> None:
        r = self.requirement(nodes)
        heapq.heappush(self._heap, (-r, next(self._counter), nodes))

    def pop(self) -> tuple[float, list[int]]:
        negr, _, nodes = heapq.heappop(self._heap)
        return -negr, nodes

    def __bool__(self) -> bool:
        return bool(self._heap)


_FITS, _SPLIT, _STUCK = 0, 1, 2


def _memo_witness(wf: Workflow, nodes: list[int], exact_limit: int,
                  memo: dict) -> tuple:
    """Content-keyed requirement witness, shared across the k' sweep.

    One computation serves every consumer that prices the same block
    content: Step 2's priority queue, Step 3's per-vertex entries
    (Step 2 hands Step 3 exactly the blocks it just priced), and the
    slow-path merged-union checks.  ``nodes`` must be ascending (all
    block lists in this module are) for keys to unify.
    """
    key = tuple(nodes)
    e = memo.get(key)
    if e is None:
        counters.bump("step2_memo_misses")
        e = block_requirement_witness(wf, nodes, exact_limit=exact_limit)
        memo[key] = e
    else:
        counters.bump("step2_memo_hits")
    return e


def _split_block(queue: _BlockPQ, nodes: list[int]) -> list[list[int]]:
    """Bisect ``nodes``; memoized by content across the k' sweep."""
    key = ("split", tuple(nodes))
    parts = queue.memo.get(key)
    if parts is None:
        parts = partition_block(queue.wf, nodes, 2)
        queue.memo[key] = parts
    return parts


def _fit_block(
    nodes: list[int],
    r: float,
    queue: _BlockPQ,
    cap: float,
) -> int:
    """FitBlock (Algorithm 2) without the mapping side effect.

    ``_FITS``: block fits ``cap``.  ``_SPLIT``: did not fit, pieces
    reinserted into the queue.  ``_STUCK``: singleton exceeding ``cap``
    — cannot be split; the paper's FitBlock would loop, we hand it to
    Step 3, which may still merge it into a block on a larger-memory
    processor.
    """
    if r <= cap:
        return _FITS
    if len(nodes) > 1:
        for part in _split_block(queue, nodes):
            queue.push(part)
        return _SPLIT
    return _STUCK


def _biggest_assign(
    wf: Workflow,
    platform: Platform,
    blocks: list[list[int]],
    exact_limit: int,
    memo: dict | None = None,
) -> _Step2Result:
    """Algorithm 1: assign biggest blocks to biggest memories."""
    queue = _BlockPQ(wf, exact_limit, memo)
    for b in blocks:
        queue.push(b)
    proc_ids = platform.sorted_by_memory()
    assigned: list[tuple[list[int], int]] = []
    stuck: list[list[int]] = []
    next_proc = 0
    while queue and next_proc < len(proc_ids):
        r, nodes = queue.pop()
        pj = proc_ids[next_proc]
        status = _fit_block(nodes, r, queue, platform.memory(pj))
        if status == _FITS:
            assigned.append((nodes, pj))
            next_proc += 1
        elif status == _STUCK:
            stuck.append(nodes)
    # remaining blocks: shrink them to the smallest memory (no mapping)
    unassigned: list[list[int]] = list(stuck)
    if queue:
        min_mem = platform.min_memory()
        while queue:
            r, nodes = queue.pop()
            if r <= min_mem or len(nodes) == 1:
                unassigned.append(nodes)
            else:
                for part in _split_block(queue, nodes):
                    queue.push(part)
    return _Step2Result(assigned, unassigned)


# ---------------------------------------------------------------------- #
# Step 3: merging (Algorithms 3–4)
# ---------------------------------------------------------------------- #
class _Requirements:
    """LRU-bounded, merge-aware cache of ``r_V`` keyed by vertex id.

    Entries are ``(r, base, peak_w, order)``: the reported requirement,
    the persistent residency base, and a concrete traversal witness
    ``order`` with simulated transient peak ``peak_w`` (see
    :func:`repro_torch.core.memdag.block_requirement_witness`).

    Composition (the merge fast path): for a pair merge A∪B whose
    quotient edges all run A→B with total cross volume ``X``, executing
    A's witness then B's witness is a valid traversal, and every step
    carries at most ``X`` extra live bytes (the A→B files), hence::

        r(A∪B) ≤ base_A + base_B + max(peak_A, peak_B) + X      (ub)
        r(A∪B) ≥ max(r_A, r_B)                                  (lb)

    (The lb holds for true min-peaks — merging only converts streamed
    externals into held internals; on the heuristic estimates it is
    used as a pruning signal.)  When ``ub`` already fits the target
    memory, or ``lb`` already exceeds it, FindMSOptMerge prices the
    candidate without re-running the min-peak traversal search.

    Committed merges *pin* a composed entry (concatenated witness,
    re-simulated peak): pinned witnesses are not reproducible from a
    fresh greedy run, so they are exempt from LRU eviction and are
    exported into ``MappingResult.extras["orders"]`` as feasibility
    witnesses for validation.
    """

    def __init__(self, wf: Workflow, exact_limit: int,
                 max_entries: int = 8192,
                 sweep_memo: dict | None = None) -> None:
        self.wf = wf
        self.exact_limit = exact_limit
        self.max_entries = max_entries
        self.sweep_memo = sweep_memo if sweep_memo is not None else {}
        self._lru: OrderedDict[int, tuple] = OrderedDict()
        self._pinned: dict[int, tuple] = {}

    def entry(self, q: QuotientGraph, vid: int) -> tuple:
        e = self._pinned.get(vid)
        if e is not None:
            return e
        e = self._lru.get(vid)
        if e is not None:
            self._lru.move_to_end(vid)
            return e
        # content-keyed reuse: Step 2 priced this exact block already
        e = _memo_witness(self.wf, sorted(q.members[vid]),
                          self.exact_limit, self.sweep_memo)
        self._lru[vid] = e
        if len(self._lru) > self.max_entries:
            self._lru.popitem(last=False)
        return e

    def of(self, q: QuotientGraph, vid: int) -> float:
        return self.entry(q, vid)[0]

    def forget(self, *vids: int) -> None:
        for v in vids:
            self._lru.pop(v, None)
            self._pinned.pop(v, None)

    @staticmethod
    def bound_pair(e_a: tuple, e_b: tuple, cross: float) -> tuple[float, float]:
        """``(lb, ub)`` on the merged requirement (see class docstring)."""
        lb = max(e_a[0], e_b[0])
        ub = e_a[1] + e_b[1] + max(e_a[2], e_b[2]) + cross
        return lb, ub

    def commit_merged(self, q: QuotientGraph, vm: int,
                      compose: tuple | None) -> None:
        """Pin an entry for a committed merge result ``vm``.

        ``compose`` is ``(e_first, e_second)`` — part entries in
        topological order — for a pair merge, or ``None`` (triple
        merges interleave, so the witness is recomputed from scratch).
        """
        if compose is not None:
            e1, e2 = compose
            order = e1[3] + e2[3]
            base = e1[1] + e2[1]
            peak_w = simulate_peak_members(self.wf, q.members[vm], order)
            entry = (base + peak_w, base, peak_w, order)
            # a slow-path acceptance already priced this exact content
            # with the full traversal search — keep the tighter of the
            # two, else the pinned entry over-prices the block for all
            # later merge bounds and Step-4 memory checks
            known = self.sweep_memo.get(tuple(sorted(q.members[vm])))
            if known is not None and known[0] < entry[0]:
                entry = known
        else:
            entry = block_requirement_witness(
                self.wf, sorted(q.members[vm]),
                exact_limit=self.exact_limit)
        self._pinned[vm] = entry

    def snapshot(self, q: QuotientGraph) -> dict[int, float]:
        """``{vid: r}`` for all live vertices — plain-dict requirement
        lookups for Step 4, where the partition no longer changes."""
        return {vid: self.of(q, vid) for vid in q.members}

    def witness_orders(self, q: QuotientGraph) -> dict[int, list[int]]:
        """Feasibility witnesses for all live vertices with entries."""
        out: dict[int, list[int]] = {}
        for vid in q.members:
            e = self._pinned.get(vid) or self._lru.get(vid)
            if e is not None:
                out[vid] = e[3]
        return out


def _find_ms_opt_merge(
    v: int,
    neighbours: list[int],
    ev: IncrementalEvaluator,
    platform: Platform,
    reqs: _Requirements,
    pinned: frozenset[int] | set[int] = frozenset(),
) -> tuple[float, int | None, int | None]:
    """Algorithm 3: best merge of unassigned ``v`` into a candidate.

    ``neighbours`` is the pre-filtered, sorted candidate list (callers
    intersect ``v``'s adjacency with the eligible assigned set — O(deg)
    instead of O(V) set algebra per queue item).  Returns
    ``(best_makespan, best_partner, optional_third)``; partner is
    ``None`` when no feasible merge exists.  ``Γ`` is restored to its
    input state before returning.  Candidates are priced by
    delta-evaluation on ``ev`` with rollback; memory feasibility uses
    the composition bounds of :class:`_Requirements` and only falls
    back to the full min-peak traversal search when the bounds are
    inconclusive (or for triple merges, whose parts interleave).

    ``pinned`` blocks (warm-start mode: in-flight on their processor)
    may *absorb* ``v`` — the merged block keeps their processor — but a
    triple merge whose third partner is pinned is rejected: absorbing
    the third would strip it of its own processor, i.e. move it.
    """
    q = ev.q
    best_ms = float("inf")
    best_partner: int | None = None
    best_third: int | None = None
    if not neighbours:
        return best_ms, None, None
    ev.ensure_exact_ranks()  # bounded settles need the rank invariant
    e_v = reqs.entry(q, v)
    for vp in neighbours:
        target_proc = q.proc[vp]
        cap = platform.memory(target_proc)
        e_vp = reqs.entry(q, vp)
        cross = q.succ[v].get(vp, 0.0) + q.succ[vp].get(v, 0.0)
        lb, ub = reqs.bound_pair(e_v, e_vp, cross)
        if lb > cap:
            continue  # merged block cannot fit — skip the trial entirely
        # A 2-cycle after the pair merge (-> triple merge) is possible
        # only through a common out/in neighbour; knowing that up front
        # gates both cheap paths below.
        down, up = ((vp, v) if vp in q.succ[v] else (v, vp))
        two_cycle = q.succ[up].keys() & q.pred[down].keys()
        may_triple = bool(two_cycle)
        if may_triple:
            # the triple partner is known pre-merge (cycle_through
            # returns the smallest common neighbour): reject by the
            # requirement lower bound before any structural work
            other = min(two_cycle)
            if other in pinned:
                continue  # absorbing a pinned block would move it
            e_other = reqs.entry(q, other)
            if max(e_v[0], e_vp[0], e_other[0]) > cap:
                continue
        # O(1) makespan rejection before any structural work: chains
        # through the merged vertex cost at least its own time plus the
        # downstream part's child term (unchanged by a *pair* merge; a
        # triple merge may absorb that child, voiding the bound).
        if not may_triple and best_ms < float("inf"):
            own_vm = ((q.weight[v] + q.weight[vp])
                      / platform.speed(target_proc))
            child_term = ev.bottom_weight(down) - ev.own_time(down)
            if own_vm + child_term > best_ms + 1e-9 * abs(best_ms):
                continue
        if not may_triple:
            # Pair merges never need the frame machinery: feasibility
            # is decided on the member union (composition bound, then
            # concatenated-witness simulation, then the full traversal
            # search) and pricing goes through a structure-only
            # overlay probe.
            if ub > cap:  # composition bound inconclusive
                e_up = e_v if up == v else e_vp
                e_down = e_vp if e_up is e_v else e_v
                union = q.members[v] | q.members[vp]
                base = e_v[1] + e_vp[1]
                peak_sim = simulate_peak_members(
                    reqs.wf, union, e_up[3] + e_down[3])
                if base + peak_sim > cap:
                    r = _memo_witness(reqs.wf, sorted(union),
                                      reqs.exact_limit,
                                      reqs.sweep_memo)[0]
                    if r > cap:
                        continue
            ms = ev.probe_merge(v, vp, target_proc, best_ms)
            if ms is not None:
                best_ms, best_partner, best_third = ms, vp, None
            continue
        # may_triple: the pair merge is *guaranteed* cyclic (vm <-> the
        # common neighbour), so this is always a frame-managed triple
        ev.begin()
        vm, cycle = ev.merge(v, vp)
        assert cycle is not None, "pair merge with common neighbour"
        if len(cycle) != 2:
            ev.rollback()
            continue
        third = cycle[0] if cycle[0] != vm else cycle[1]
        if third in pinned:
            ev.rollback()
            continue
        vm, cycle = ev.merge(vm, third)
        if cycle is not None:
            ev.rollback()
            continue
        r = _memo_witness(reqs.wf, sorted(q.members[vm]),
                          reqs.exact_limit, reqs.sweep_memo)[0]
        if r <= cap:
            ev.set_proc(vm, target_proc)
            ms = ev.makespan()
            if ms < best_ms:
                best_ms, best_partner, best_third = ms, vp, third
        ev.rollback()
    return best_ms, best_partner, best_third


def _merge_unassigned(
    wf: Workflow,
    platform: Platform,
    q: QuotientGraph,
    reqs: _Requirements,
    ev: IncrementalEvaluator,
    pinned: set[int] | None = None,
) -> dict | None:
    """Algorithm 4.  Mutates ``q``; ``None`` on success, else a failure
    record ``{"reason", "gap", "block_size"}`` describing the block that
    could not be merged or placed (``gap`` is its requirement minus the
    largest processor memory — positive means no processor could ever
    hold it, non-positive means the capacity exists but every feasible
    merge/idle placement was exhausted).

    Beyond-paper refinement (DESIGN.md §8): when no merge is feasible,
    try placing the block on a memory-feasible *idle* processor before
    giving up — the paper only uses idle processors in Step 4, after a
    full assignment exists, which strands late-split singletons whose
    requirement exceeds every assigned block's headroom.

    The critical path comes from the maintained evaluator state, and
    committed merges pin composed requirement entries so later merges
    into the grown block stay on the O(1) bound fast path.  The
    assigned/busy/path sets are maintained incrementally — per-item
    work is O(deg), not O(V).

    ``pinned`` (warm-start mode) marks assigned blocks whose processor
    must not change: they may absorb unassigned blocks (the merged
    block keeps their processor and inherits the pin — ``pinned`` is
    updated in place), but never lose their own assignment.
    """
    if pinned is None:
        pinned = set()
    path = ev.critical_path_set()
    assigned = {v for v in q.vertices() if q.proc[v] is not None}
    busy = {q.proc[a] for a in assigned}
    queue = deque(v for v in sorted(q.vertices()) if q.proc[v] is None)
    seen_count: dict[int, int] = {v: 0 for v in queue}
    while queue:
        v = queue.popleft()
        nbrs = sorted(
            w for w in itertools.chain(q.pred[v], q.succ[v])
            if w in assigned and w not in path
        )
        ms, partner, third = _find_ms_opt_merge(
            v, nbrs, ev, platform, reqs, pinned)
        if partner is None:
            # off-path candidates are all proven infeasible at this
            # point (a feasible one would have set a partner), so the
            # fallback scan only needs the path-restricted remainder
            nbrs = sorted(
                w for w in itertools.chain(q.pred[v], q.succ[v])
                if w in assigned and w in path
            )
            ms, partner, third = _find_ms_opt_merge(
                v, nbrs, ev, platform, reqs, pinned)
        if partner is None:
            # place-on-idle fallback
            r_v = reqs.of(q, v)
            idle = [j for j in range(platform.k)
                    if j not in busy and platform.memory(j) >= r_v]
            if idle:
                pj = max(idle, key=platform.speed)
                ev.set_proc(v, pj)
                assigned.add(v)
                busy.add(pj)
                path = ev.critical_path_set()
                continue
        if partner is not None:
            target_proc = q.proc[partner]
            was_pinned = partner in pinned
            # capture part entries before the merge for witness
            # composition (quotient edges between v/partner run one way)
            first, second = ((v, partner) if partner in q.succ[v]
                             else (partner, v))
            compose = (reqs.entry(q, first), reqs.entry(q, second))
            vm, cycle = ev.merge(v, partner)
            assigned.discard(partner)
            reqs.forget(v, partner)
            if third is not None:
                third_proc = q.proc[third]
                vm2, cycle = ev.merge(vm, third)
                assert cycle is None, "triple merge no longer acyclic"
                assigned.discard(third)
                if third_proc is not None:
                    busy.discard(third_proc)  # absorbed block frees it
                reqs.forget(vm, third)
                if third_proc is None and third in queue:
                    queue.remove(third)
                vm = vm2
                compose = None  # interleaved parts: recompute witness
            ev.set_proc(vm, target_proc)
            reqs.commit_merged(q, vm, compose)
            assigned.add(vm)
            if was_pinned:
                # the merged block stays on the pinned processor; the
                # pin survives so Step 4 never moves it either
                pinned.discard(partner)
                pinned.add(vm)
            path = ev.critical_path_set()
        else:
            unresolved_nbrs = any(
                q.proc[w] is None
                for w in itertools.chain(q.pred[v], q.succ[v])
            )
            if unresolved_nbrs and seen_count.get(v, 0) <= 1:
                seen_count[v] = seen_count.get(v, 0) + 1
                queue.append(v)
            else:
                # no solution for this k'
                r_v = reqs.of(q, v)
                size = len(q.members[v])
                return {
                    "reason": (
                        f"block of {size} task(s) with requirement "
                        f"{r_v:.4g} has no feasible merge or idle "
                        f"placement"
                    ),
                    "gap": r_v - platform.max_memory(),
                    "block_size": size,
                }
    return None


# ---------------------------------------------------------------------- #
# Step 4: swaps + idle-processor moves (Algorithm 5)
# ---------------------------------------------------------------------- #
def _swap_candidates(
    q: QuotientGraph,
    platform: Platform,
    ev: IncrementalEvaluator,
):
    """Pruned best-improvement neighborhood: pairs touching the path.

    A swap that leaves every current maximum-weight chain untouched
    cannot lower the makespan (the untouched chain keeps its exact
    bottom weight), so one endpoint must lie on the maintained critical
    path.  For an off-path partner, the path endpoint must additionally
    move to a strictly *faster* processor — its own term ``w_v / s_v``
    is the only path term a swap can change.
    """
    path = ev.critical_path()
    on_path = set(path)
    verts = sorted(q.vertices())
    seen: set[tuple[int, int]] = set()
    for v in path:
        pa = q.proc[v]
        for vp in verts:
            if vp == v:
                continue
            key = (v, vp) if v < vp else (vp, v)
            if key in seen:
                continue
            seen.add(key)
            pb = q.proc[vp]
            if vp not in on_path and \
                    platform.speed(pb) <= platform.speed(pa):
                continue
            yield v, vp


def _swap_pass(
    wf: Workflow,
    platform: Platform,
    q: QuotientGraph,
    reqs: _Requirements,
    ev: IncrementalEvaluator,
    *,
    exhaustive: bool = False,
    full_scan_fallback: bool = True,
    pinned: set[int] | None = None,
    probe_cache: bool = True,
) -> None:
    """Best-improvement swaps, delta-evaluated with rollback.

    The scan is restricted to the pruned critical-path neighborhood
    (:func:`_swap_candidates`); once it is exhausted, one exhaustive
    O(V²) verification scan runs (``full_scan_fallback``) — cheap now
    that each probe is a delta evaluation instead of a full sweep.
    ``exhaustive=True`` forces full scans throughout (test oracle).
    ``pinned`` blocks (warm-start mode) never swap.

    Dependency-region probe caching (``probe_cache``): rescans after
    an applied swap re-probe mostly pairs whose verdict cannot have
    changed.  A "no improvement" probe verdict for pair ``(v, vp)``
    stays *exactly* reproducible while (a) no vertex whose bottom
    weight or processor changed lies in the pair's read closure —
    ``{v, vp}``, their ancestors, and those vertices' children — and
    (b) the probe's *head* (the untouched vertex whose maintained
    weight supplied the final max, ``ev.last_probe_head``) kept its
    value; the improvement bound only ever tightens within a pass, so
    a cached rejection can never hide a fresh improvement.  After each
    applied swap the touched region — descendant closure of the
    changed vertices, the swapped pair and their parents — is stamped,
    and cached verdicts are reused only when both endpoints (and the
    head) predate every stamp.  Cache reuse therefore replicates the
    uncached scan decision-for-decision: final mappings are
    bit-identical with the cache on or off (property-tested).
    """
    if pinned is None:
        pinned = frozenset()
    ev.ensure_exact_ranks()
    req_of = reqs.snapshot(q)  # partition is frozen during Step 4
    mem_of = [platform.memory(j) for j in range(platform.k)]
    best_ms = ev.makespan()
    full_checked = False
    verdicts: dict[tuple[int, int], tuple[int, int | None]] = {}
    inv_stamp: dict[int, int] = {}   # vid -> last scan touching its region
    l_stamp: dict[int, int] = {}     # vid -> last scan its l changed
    scan = 0
    while True:
        best_pair: tuple[int, int] | None = None
        run_full = exhaustive or full_checked
        if exhaustive:
            verts = sorted(q.vertices())
            pairs = ((v, vp) for i, v in enumerate(verts)
                     for vp in verts[i + 1:])
        elif run_full:
            # Verification scan: drop only the speed prune.  Pairs with
            # both endpoints off the critical path stay excluded — the
            # untouched path keeps its bottom weight, so those swaps
            # cannot lower the makespan (see _swap_candidates).
            on_path = set(ev.critical_path())
            verts = sorted(q.vertices())
            pairs = ((v, vp) for i, v in enumerate(verts)
                     for vp in verts[i + 1:]
                     if v in on_path or vp in on_path)
        else:
            pairs = _swap_candidates(q, platform, ev)
        for v, vp in pairs:
            if v in pinned or vp in pinned:
                continue
            pa, pb = q.proc[v], q.proc[vp]
            if pa == pb:
                continue
            # O(1) sound rejection: after the swap, vp's bottom weight
            # rises by its own-time increase, offset at most by v's
            # own-time gain (v appears at most once below vp), so
            # ms' >= l(vp) + rise(vp) - gain(v).  A small slack keeps
            # borderline cases on the exact probe path.
            sa, sb = platform.speed(pa), platform.speed(pb)
            rise_vp = q.weight[vp] / sa - q.weight[vp] / sb
            gain_v = q.weight[v] / sa - q.weight[v] / sb
            lb = ev.bottom_weight(vp) + rise_vp - max(0.0, gain_v)
            if lb > best_ms + 1e-9 * abs(best_ms):
                continue
            if req_of[v] > mem_of[pb]:
                continue
            if req_of[vp] > mem_of[pa]:
                continue
            key = (v, vp) if v < vp else (vp, v)
            if probe_cache:
                ent = verdicts.get(key)
                if ent is not None:
                    s, head = ent
                    if (inv_stamp.get(v, -1) <= s
                            and inv_stamp.get(vp, -1) <= s
                            and (head is None
                                 or l_stamp.get(head, -1) <= s)):
                        counters.bump("swap_probe_cache_hits")
                        continue
            counters.bump("swap_probes")
            ms = ev.probe_swap(v, vp, best_ms - 1e-12)
            if ms is not None:
                best_ms = ms
                best_pair = (v, vp)
                verdicts.pop(key, None)
            elif probe_cache:
                verdicts[key] = (scan, ev.last_probe_head)
        if best_pair is None:
            if run_full or not full_scan_fallback:
                return
            full_checked = True   # pruned neighborhood exhausted: verify
            continue
        changed = ev.swap_and_changes(*best_pair)
        full_checked = False
        if probe_cache:
            scan += 1
            for x in changed:
                l_stamp[x] = scan
            # invalidation region: descendants of everything whose
            # value or processor moved, plus of the parents of the
            # value-changed vertices (parents *read* a changed child)
            seeds = set(changed)
            seeds.update(best_pair)
            region = set(seeds)
            for x in changed:
                region.update(q.pred[x])
            stack = list(region)
            while stack:
                u = stack.pop()
                for w in q.succ[u]:
                    if w not in region:
                        region.add(w)
                        stack.append(w)
            for x in region:
                inv_stamp[x] = scan


def _idle_moves(
    wf: Workflow,
    platform: Platform,
    q: QuotientGraph,
    reqs: _Requirements,
    ev: IncrementalEvaluator,
    pinned: set[int] | None = None,
) -> None:
    """Move critical-path blocks to faster idle processors.

    Walks the evaluator's maintained critical path; each probe is a
    transactional reassignment, committed only on improvement.
    ``pinned`` blocks (warm-start mode) never move.
    """
    if pinned is None:
        pinned = frozenset()
    busy = {q.proc[v] for v in q.vertices()}
    idle = [j for j in range(platform.k) if j not in busy]
    if not idle:
        return
    ev.ensure_exact_ranks()
    moved: set[int] = set()
    while True:
        path = ev.critical_path()
        cand = [v for v in path if v not in moved and v not in pinned]
        if not cand:
            return
        ms0 = ev.makespan()
        progressed = False
        for v in cand:
            moved.add(v)
            cur = q.proc[v]
            options = [
                j for j in idle
                if platform.speed(j) > platform.speed(cur)
                and reqs.of(q, v) <= platform.memory(j)
            ]
            if not options:
                continue
            j = max(options, key=platform.speed)
            if ev.probe_move(v, j, ms0 - 1e-12) is not None:
                ev.set_proc(v, j)
                idle.remove(j)
                idle.append(cur)
                progressed = True
                break  # critical path changed; recompute
        if not progressed:
            return


# ---------------------------------------------------------------------- #
# entry point
# ---------------------------------------------------------------------- #
def kprime_sweep_values(wf: Workflow, platform: Platform,
                        mode: str = "auto") -> list[int]:
    """Which k' values to try (paper: all of 1..k; we default to a
    geometric subset for very large workflows — a documented knob).

    The subset always contains 1, 2, 3, ``max(1, k // 2)`` and ``k``:
    half the platform is the sweep's empirically strongest anchor on
    wide workflows, and the geometric ladder can otherwise step over
    it.  Values are deduplicated before sorting, so small ``k`` (where
    the anchors collide) yields each candidate exactly once.
    """
    k = platform.k
    if mode == "full" or (mode == "auto" and wf.n <= 4000):
        return list(range(1, k + 1))
    vals = [1, 2, 3, max(1, k // 2), k]
    v = 4
    while v < k:
        vals.append(v)
        v = int(v * 1.6) + 1
    return sorted({x for x in vals if 1 <= x <= k})


def dag_het_part(
    wf: Workflow,
    platform: Platform,
    *,
    kprime: str | list[int] = "auto",
    exact_limit: int = 0,
    verbose: bool = False,
) -> MappingResult | None:
    """Run the four-step heuristic, sweeping k' and keeping the best.

    .. deprecated::
        Use :class:`repro_torch.core.scheduler.Scheduler` (or the
        :func:`repro_torch.core.scheduler.schedule` shorthand), which returns
        a :class:`~repro_torch.core.scheduler.ScheduleReport` — never ``None``
        — with the k'→makespan sweep trace, per-stage timings and a
        structured infeasibility diagnosis, and can run the k' sweep on
        a process pool (``workers>1``).  This wrapper keeps the old
        ``MappingResult | None`` contract by returning ``report.best``.
    """
    warnings.warn(
        "dag_het_part() is deprecated; use repro_torch.core.scheduler."
        "Scheduler (returns a ScheduleReport instead of "
        "MappingResult | None)",
        DeprecationWarning, stacklevel=2,
    )
    from .scheduler import schedule

    report = schedule(wf, platform, algorithm="dag_het_part",
                      kprime=kprime, exact_limit=exact_limit,
                      verbose=verbose)
    return report.best
