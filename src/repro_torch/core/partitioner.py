"""Acyclic DAG partitioning — stand-in for dagP (paper Step 1).

The paper uses the external multilevel partitioner dagP (Herrmann et
al., SISC 2019) as a black box: ``Partition(G, k)`` returns an acyclic
k-way partition optimizing edge cut under a balance constraint.  We
implement the same interface natively (DESIGN.md §3.4):

1. a *locality-preserving topological order* (ready tasks whose parents
   were scheduled most recently go first — keeps chains together),
2. a *contiguous split* of that order into ``k`` chunks of roughly equal
   vertex weight — by construction every edge goes from an
   earlier-or-equal chunk to a later-or-equal chunk, so the quotient
   graph is acyclic,
3. *FM-style boundary refinement*: single-vertex moves between
   neighbouring chunks that reduce the edge cut, constrained so the
   ``b(u) <= b(v)`` invariant (and hence acyclicity) is preserved and
   blocks stay within ``(1 + eps)`` of the weight target.

The refinement is repeated for ``passes`` rounds of best-improvement
sweeps.  Deterministic throughout.

Two implementations share the decision logic (the Step-2 pattern from
:mod:`repro_torch.core.memdag`):

* the **scalar** path walks the adjacency dicts directly,
* the **flat** path works over the CSR snapshot
  (:func:`repro_torch.core.memdag._flat_view`) and replaces the
  all-vertices-per-pass scan with a vectorized boundary prefilter — a
  vertex is only visited when it had a block-distance-1 neighbour at
  pass start or a neighbour moved earlier in the pass.  Every visited
  vertex is then evaluated with verbatim scalar logic, so the flat
  single-level path is *bit-identical in decisions* to the scalar one
  (property-tested in ``tests/test_step1_flat.py``).

:func:`set_step1_impl` selects the path like ``memdag.set_step2_impl``.
``acyclic_partition(..., multilevel=True)`` additionally enables
**multilevel** partitioning (coarsen → partition → uncoarsen, the dagP
shape): deterministic heavy-edge acyclic coarsening contracts only
edges whose contraction keeps the quotient acyclic, the coarsest graph
is partitioned with the standard path, and each level refines with the
flat FM sweep.  Multilevel intentionally changes cuts, so it is opt-in
(``SchedulerConfig.step1_multilevel``), never part of ``"auto"``.
"""
from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np

from . import counters
from .dag import Workflow
from .memdag import _flat_view

__all__ = [
    "acyclic_partition",
    "partition_block",
    "edge_cut",
    "set_step1_impl",
    "step1_impl",
]

#: Step-1 partitioner implementation: "auto" dispatches large graphs to
#: the flat-array path and small ones to the scalar path; "scalar" /
#: "flat" force one side (property tests, benchmarks).  Both paths are
#: bit-identical (see docs/architecture.md, "Flat-array Step 1").
_STEP1_IMPL = "auto"

#: graphs below this many tasks stay on the scalar path in "auto" mode —
#: the numpy prefilter and CSR gathers only amortize once a pass over
#: all vertices costs more than a few array ops (measured crossover in
#: the few-hundreds of tasks).
_FLAT_CUTOVER = 512

#: multilevel coarsening stops once a level has at most
#: ``max(8 * k, _COARSEN_FLOOR)`` vertices — enough resolution for the
#: contiguous split to balance k blocks well.
_COARSEN_FLOOR = 256

#: bounded DFS budget of the coarsening cycle probe; on exhaustion the
#: candidate edge is conservatively rejected (never contracted), which
#: preserves acyclicity at worst coarsening speed.
_PROBE_CAP = 64


def set_step1_impl(mode: str) -> str:
    """Select the Step-1 implementation; returns the previous mode.

    ``"auto"`` (default) uses the flat-array path for graphs of at
    least ``_FLAT_CUTOVER`` tasks and the scalar path below;
    ``"scalar"`` / ``"flat"`` force one implementation everywhere.
    Results are bit-identical in every mode (asserted by
    ``tests/test_step1_flat.py``); the knob exists for benchmarks
    (``make bench-step1`` records the scalar-vs-flat Step-1 share
    under ``"step1"`` in ``BENCH_runtime.json``) and property tests.
    """
    global _STEP1_IMPL
    if mode not in ("auto", "scalar", "flat"):
        raise ValueError(f"unknown Step-1 impl {mode!r}")
    prev = _STEP1_IMPL
    _STEP1_IMPL = mode
    return prev


def step1_impl() -> str:
    """The currently selected Step-1 implementation mode."""
    return _STEP1_IMPL


def _use_flat(n: int) -> bool:
    """Dispatch predicate of :func:`acyclic_partition`."""
    if _STEP1_IMPL == "flat":
        return True
    return _STEP1_IMPL == "auto" and n >= _FLAT_CUTOVER


# ---------------------------------------------------------------------- #
# locality order (shared by both paths)
# ---------------------------------------------------------------------- #
def _order_and_total(wf: Workflow) -> tuple[list[int], float]:
    """Locality topo order plus total work, memoized per workflow.

    Kahn's algorithm with ready tasks keyed by most-recent parent.  The
    k' sweep re-partitions the same graph up to k times, so the order
    (and the total, whose float association the contiguous split's
    decisions depend on) is cached on the instance.  The cache key
    includes the task/edge counts *and* the workflow mutation counter
    (``Workflow._version``), so a same-shape edit — e.g. accumulating
    cost onto an existing edge — can never return a stale order.
    """
    cached = getattr(wf, "_locality_order_cache", None)
    version = getattr(wf, "_version", 0)
    if cached is not None:
        n, n_edges, ver, order, total = cached
        if n == wf.n and n_edges == wf.n_edges and ver == version:
            return order, total

    indeg = [len(wf.pred[u]) for u in range(wf.n)]
    pos = [-1] * wf.n  # scheduling position of each task
    # key: (-last_parent_position, task id)  → children follow parents
    heap = [(0, u) for u in range(wf.n) if indeg[u] == 0]
    heapq.heapify(heap)
    order: list[int] = []
    while heap:
        _, u = heapq.heappop(heap)
        pos[u] = len(order)
        order.append(u)
        for v in wf.succ[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                last = max(pos[p] for p in wf.pred[v])
                heapq.heappush(heap, (-last, v))
    if len(order) != wf.n:
        raise ValueError("cannot partition a cyclic graph")
    total = sum(wf.work[u] for u in order) or float(wf.n)
    wf._locality_order_cache = (wf.n, wf.n_edges, version, order, total)
    return order, total


def _locality_topo_order(wf: Workflow) -> list[int]:
    """Kahn's algorithm, ready tasks keyed by most-recent parent."""
    return _order_and_total(wf)[0]


def edge_cut(wf: Workflow, block_of: Sequence[int]) -> float:
    """Total weight of edges crossing blocks.

    Large graphs take a vectorized path over the CSR snapshot; its
    pairwise float summation can differ from the scalar loop's
    sequential association by rounding noise, which is fine for an
    observability metric (never a scheduling decision input).
    """
    if wf.n_edges >= 2048:
        fv = _flat_view(wf)
        b = np.asarray(block_of, dtype=np.int64)
        e_src = np.repeat(np.arange(wf.n, dtype=np.int64),
                          np.diff(fv.s_indptr))
        return float(fv.s_cost[b[e_src] != b[fv.s_dst]].sum())
    return sum(
        c
        for u in range(wf.n)
        for v, c in wf.succ[u].items()
        if block_of[u] != block_of[v]
    )


# ---------------------------------------------------------------------- #
# contiguous split (shared decision logic of both paths)
# ---------------------------------------------------------------------- #
def _contiguous_split(
    order: list[int], work: Sequence[float], total: float, k: int
) -> tuple[list[int], int]:
    """Split ``order`` into ≤ k contiguous chunks of ~equal work.

    Returns ``(block_of, k_eff)``.  Every edge then goes from an
    earlier-or-equal chunk to a later-or-equal chunk, so the quotient
    is acyclic by construction.
    """
    n = len(order)
    block_of = [0] * n
    b = 0
    acc = 0.0
    remaining = n
    uniform = total == float(n)
    target = total / k
    thresh = target * 1.0001
    for u in order:
        wu = 1.0 if uniform else work[u]
        # close the block if the next task overshoots the target, but
        # keep enough tasks to make all remaining blocks non-empty.
        # open block b+1 only if the remaining tasks (incl. this one)
        # can still populate blocks b+1 .. k-1 with ≥1 task each.
        if (
            b < k - 1
            and acc > 0.0
            and acc + wu > thresh
            and remaining >= (k - 1 - b)
        ):
            b += 1
            acc = 0.0
        block_of[u] = b
        acc += wu
        remaining -= 1
    return block_of, b + 1


def _compress_ids(block_of: list[int]) -> list[int]:
    """Compact block ids (refinement may empty a block entirely)."""
    used = sorted(set(block_of))
    remap = {b: i for i, b in enumerate(used)}
    return [remap[b] for b in block_of]


# ---------------------------------------------------------------------- #
# scalar path
# ---------------------------------------------------------------------- #
def _acyclic_partition_scalar(
    wf: Workflow, k: int, eps: float, passes: int
) -> list[int]:
    n = wf.n
    counters.bump("step1_scalar_calls")
    order, total = _order_and_total(wf)
    block_of, k_eff = _contiguous_split(order, wf.work, total, k)
    if k_eff <= 1:
        return block_of

    # --- FM-style boundary refinement --------------------------------- #
    weights = [0.0] * k_eff
    counts = [0] * k_eff  # O(1) "don't empty a block" guard
    for u in range(n):
        weights[block_of[u]] += wf.work[u]
        counts[block_of[u]] += 1
    cap = (1.0 + eps) * (total / k_eff)

    def gain(u: int, dst: int) -> float:
        src = block_of[u]
        g = 0.0
        for v, c in wf.succ[u].items():
            if block_of[v] == dst:
                g += c
            elif block_of[v] == src:
                g -= c
        for v, c in wf.pred[u].items():
            if block_of[v] == dst:
                g += c
            elif block_of[v] == src:
                g -= c
        return g

    moves = 0
    passes_run = 0
    for _ in range(passes):
        passes_run += 1
        improved = False
        for u in range(n):
            src = block_of[u]
            # fused legality/candidacy probe (keys only, no floats):
            # moving down needs no pred in >= src; up needs no succ in
            # <= src; a direction with no edge into the target block
            # has gain <= 0 and is never taken — same decisions as
            # evaluating gain() for every direction, at a fraction of
            # the traversals.
            down_ok = src > 0
            up_ok = src < k_eff - 1
            has_down = has_up = False
            for s in wf.succ[u]:
                b = block_of[s]
                if b <= src:
                    up_ok = False
                if b == src - 1:
                    has_down = True
                elif b == src + 1:
                    has_up = True
            for p in wf.pred[u]:
                b = block_of[p]
                if b >= src:
                    down_ok = False
                if b == src - 1:
                    has_down = True
                elif b == src + 1:
                    has_up = True
            for dst in (src - 1, src + 1):
                if dst < src:
                    if not (down_ok and has_down):
                        continue
                else:
                    if not (up_ok and has_up):
                        continue
                g = gain(u, dst)
                if g <= 0.0:
                    continue
                if weights[dst] + wf.work[u] > cap:
                    continue
                # don't empty a block (keeps k' stable during refinement)
                if weights[src] - wf.work[u] <= 0.0 and counts[src] <= 1:
                    continue
                block_of[u] = dst
                weights[src] -= wf.work[u]
                weights[dst] += wf.work[u]
                counts[src] -= 1
                counts[dst] += 1
                moves += 1
                improved = True
                break
        if not improved:
            break
    counters.bump("step1_moves", moves)
    counters.bump("step1_passes", passes_run)

    return _compress_ids(block_of)


# ---------------------------------------------------------------------- #
# flat path: CSR refinement with a vectorized boundary prefilter
# ---------------------------------------------------------------------- #
def _refine_csr(
    lists: tuple,
    arrs: tuple,
    work: Sequence[float],
    block_of: list[int],
    k_eff: int,
    weights: list[float],
    counts: list[int],
    cap: float,
    passes: int,
) -> tuple[int, int]:
    """FM refinement over CSR adjacency lists — scalar decisions, flat scan.

    Replays the scalar pass exactly: the numpy prefilter only *selects*
    which vertices can possibly move, and every visited vertex is
    evaluated with the verbatim scalar legality/gain/cap logic, in
    ascending id order exactly as the scalar loop reaches them.  The
    prefilter keeps a vertex iff, at pass-start state, one direction's
    gates pass — ``has_up`` needs a successor one block ahead and
    ``up_ok`` additionally no successor in the own block (dually for
    down via predecessors; with the ``b[u] <= b[v]`` invariant those
    are the only ways the scalar gates can open) — *and* that
    direction's gain is positive.  Gate comparisons are integer; the
    pass-start gains are bit-exact replicas of the scalar
    accumulation: ``np.bincount`` adds its weights sequentially in
    input order, the concatenated (successor CSR, predecessor CSR)
    edge stream visits each vertex's terms in exactly the scalar
    interleaving, and the zero terms ``np.where`` contributes for
    uninvolved edges cannot perturb an IEEE sum (``x + 0.0 == x``; no
    ``-0.0`` arises from ``+c``/``-c`` cancellation).  A skipped
    vertex therefore falls through the scalar loop's gates or its
    ``g <= 0.0`` check with no side effects — unless a
    earlier-positioned neighbour moved first, in which case the move
    pushes it into the dirty min-heap and it is replayed at its scalar
    position.  Mutates ``block_of`` / ``weights`` / ``counts`` in
    place; returns ``(moves, passes_run)``.
    """
    si, sd, sc, pi, ps, pc = lists
    e_src, e_dst, s_cost, p_edst, p_src, p_cost = arrs
    n = len(block_of)
    b_arr = np.fromiter(block_of, dtype=np.int64, count=n)
    cat_bins = np.concatenate([e_src, p_edst])

    moves = 0
    passes_run = 0
    for _ in range(passes):
        passes_run += 1
        bu = b_arr[e_src]
        bv = b_arr[e_dst]
        d = bv - bu
        delta1 = d == 1
        same = d == 0
        has_up = np.zeros(n, dtype=bool)
        has_up[e_src[delta1]] = True
        has_down = np.zeros(n, dtype=bool)
        has_down[e_dst[delta1]] = True
        up_fail = np.zeros(n, dtype=bool)
        up_fail[e_src[same]] = True        # a successor in the own block
        down_fail = np.zeros(n, dtype=bool)
        down_fail[e_dst[same]] = True      # a predecessor in the own block
        # pass-start gains, scalar association (see docstring)
        bp = b_arr[p_src]
        bup = b_arr[p_edst]
        w_up = np.concatenate([
            np.where(delta1, s_cost, np.where(same, -s_cost, 0.0)),
            np.where(bp == bup, -p_cost, 0.0),
        ])
        w_down = np.concatenate([
            np.where(same, -s_cost, 0.0),
            np.where(bp == bup - 1, p_cost,
                     np.where(bp == bup, -p_cost, 0.0)),
        ])
        gain_up = np.bincount(cat_bins, weights=w_up, minlength=n)
        gain_down = np.bincount(cat_bins, weights=w_down, minlength=n)
        cand = np.flatnonzero(
            (has_up & ~up_fail & (b_arr < k_eff - 1) & (gain_up > 0.0))
            | (has_down & ~down_fail & (b_arr > 0) & (gain_down > 0.0))
        ).tolist()
        improved = False
        visited = bytearray(n)
        dirty: list[int] = []  # min-heap of not-yet-reached neighbours
        i = 0
        ncand = len(cand)
        bl = block_of
        while i < ncand or dirty:
            if dirty and (i >= ncand or dirty[0] < cand[i]):
                u = heapq.heappop(dirty)
            else:
                u = cand[i]
                i += 1
            if visited[u]:
                continue
            visited[u] = 1
            src = bl[u]
            # one fused sweep per adjacency side: the scalar legality
            # flags plus *both* direction gains.  Each gain variable
            # accumulates exactly the ±c sequence the scalar gain()
            # loop would produce for that direction (same edges, same
            # order), so the floats are bit-identical.
            down_ok = src > 0
            up_ok = src < k_eff - 1
            has_down = has_up = False
            g_down = 0.0
            g_up = 0.0
            later: list[int] = []  # dirty queue if the move is taken
            s0, s1 = si[u], si[u + 1]
            for j in range(s0, s1):
                w = sd[j]
                b = bl[w]
                if b <= src:
                    up_ok = False
                    if b == src:
                        c = sc[j]
                        g_down -= c
                        g_up -= c
                    elif b == src - 1:
                        has_down = True
                        g_down += sc[j]
                elif b == src + 1:
                    has_up = True
                    g_up += sc[j]
                if w > u and not visited[w]:
                    later.append(w)
            p0, p1 = pi[u], pi[u + 1]
            for j in range(p0, p1):
                w = ps[j]
                b = bl[w]
                if b >= src:
                    down_ok = False
                    if b == src:
                        c = pc[j]
                        g_down -= c
                        g_up -= c
                    elif b == src + 1:
                        has_up = True
                        g_up += pc[j]
                elif b == src - 1:
                    has_down = True
                    g_down += pc[j]
                if w > u and not visited[w]:
                    later.append(w)
            for dst in (src - 1, src + 1):
                if dst < src:
                    if not (down_ok and has_down):
                        continue
                    g = g_down
                else:
                    if not (up_ok and has_up):
                        continue
                    g = g_up
                if g <= 0.0:
                    continue
                wu = work[u]
                if weights[dst] + wu > cap:
                    continue
                if weights[src] - wu <= 0.0 and counts[src] <= 1:
                    continue
                bl[u] = dst
                b_arr[u] = dst
                weights[src] -= wu
                weights[dst] += wu
                counts[src] -= 1
                counts[dst] += 1
                moves += 1
                improved = True
                # the move can newly enable neighbours the scalar loop
                # has not reached yet (ids > u) — queue them for replay
                for w in later:
                    heapq.heappush(dirty, w)
                break
        if not improved:
            break
    return moves, passes_run


def _edge_endpoints(s_indptr: np.ndarray) -> np.ndarray:
    """Edge source ids matching the CSR edge order."""
    n = len(s_indptr) - 1
    return np.repeat(np.arange(n, dtype=np.int64), np.diff(s_indptr))


def _csr_lists(wf: Workflow, fv) -> tuple[tuple, np.ndarray]:
    """CSR adjacency as plain lists plus the edge-source array.

    The sequential replay indexes the adjacency per visited vertex;
    plain-list indexing beats numpy scalar indexing by ~5x there, and
    the k' sweep re-partitions the same workflow up to k times, so the
    converted lists are cached per instance.  Validity is by identity
    of the underlying :class:`_FlatWorkflow` view — ``_flat_view``
    already rebuilds a fresh object on any mutation it can observe.
    """
    cached = getattr(wf, "_step1_lists_cache", None)
    if cached is not None and cached[0] is fv:
        return cached[1], cached[2]
    lists = (fv.s_indptr.tolist(), fv.s_dst.tolist(), fv.s_cost.tolist(),
             fv.p_indptr.tolist(), fv.p_src.tolist(), fv.p_cost.tolist())
    arrs = (_edge_endpoints(fv.s_indptr), fv.s_dst, fv.s_cost,
            _edge_endpoints(fv.p_indptr), fv.p_src, fv.p_cost)
    wf._step1_lists_cache = (fv, lists, arrs)
    return lists, arrs


def _cut_of(b_arr: np.ndarray, e_src: np.ndarray, e_dst: np.ndarray,
            s_cost: np.ndarray) -> float:
    return float(s_cost[b_arr[e_src] != b_arr[e_dst]].sum())


def _acyclic_partition_flat(
    wf: Workflow, k: int, eps: float, passes: int
) -> list[int]:
    n = wf.n
    counters.bump("step1_flat_calls")
    order, total = _order_and_total(wf)
    block_of, k_eff = _contiguous_split(order, wf.work, total, k)
    if k_eff <= 1:
        return block_of

    fv = _flat_view(wf)
    lists, arrs = _csr_lists(wf, fv)
    e_src, e_dst = arrs[0], arrs[1]
    b_arr = np.fromiter(block_of, dtype=np.int64, count=n)
    counters.bump("step1_cut_before",
                  int(round(_cut_of(b_arr, e_src, e_dst, fv.s_cost))))
    work_np = np.asarray(wf.work, dtype=np.float64)
    # bincount accumulates sequentially in input order — the same float
    # association as the scalar path's per-vertex loop
    weights = np.bincount(b_arr, weights=work_np, minlength=k_eff).tolist()
    counts = np.bincount(b_arr, minlength=k_eff).tolist()
    cap = (1.0 + eps) * (total / k_eff)

    moves, passes_run = _refine_csr(
        lists, arrs, wf.work, block_of, k_eff, weights, counts,
        cap, passes)
    counters.bump("step1_moves", moves)
    counters.bump("step1_passes", passes_run)
    b_arr = np.fromiter(block_of, dtype=np.int64, count=n)
    counters.bump("step1_cut_after",
                  int(round(_cut_of(b_arr, e_src, e_dst, fv.s_cost))))

    return _compress_ids(block_of)


# ---------------------------------------------------------------------- #
# multilevel path: coarsen -> partition -> uncoarsen (dagP shape)
# ---------------------------------------------------------------------- #
# A level is the tuple (s_indptr, s_dst, s_cost, p_indptr, p_src,
# p_cost, work) of numpy arrays; level 0 is the workflow's CSR view.


def _no_alternative_path(
    u: int, v: int, si: list, sd: list, mate: list[int]
) -> bool:
    """No u→v path besides the direct edge, in the contracted-so-far
    graph (clusters expanded through ``mate``).  Conservative: returns
    False — "assume a path exists" — when the bounded DFS gives up, so
    a True answer is always safe to contract on.
    """
    if si[u + 1] - si[u] > _PROBE_CAP:
        return False  # hub source: seeding alone would blow the budget
    stack: list[int] = []
    seen = {u, v}
    for j in range(si[u], si[u + 1]):
        w = sd[j]
        if w == v:
            continue  # the edge being contracted
        if w not in seen:
            seen.add(w)
            stack.append(w)
    budget = _PROBE_CAP
    while stack:
        x = stack.pop()
        budget -= 1
        if budget < 0:
            return False
        mx = mate[x]
        if mx == -1:
            group = (x,)
        else:
            seen.add(mx)
            group = (x, mx)
        for y in group:
            if si[y + 1] - si[y] > _PROBE_CAP:
                return False  # hub expansion would blow the budget
            for j in range(si[y], si[y + 1]):
                w = sd[j]
                if w == v:
                    return False
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
    return True


def _coarsen_match(level: tuple, max_cluster: float) -> tuple[np.ndarray, int]:
    """One round of deterministic heavy-edge acyclic matching.

    Edges are visited heaviest-first (ties: ascending (src, dst)) and
    contracted when both endpoints are free, the merged weight respects
    ``max_cluster``, and the contraction provably keeps the quotient
    acyclic: contracting ``u→v`` is safe iff no alternative u→v path
    exists.  Two O(1) certificates skip the probe — ``outdeg(u) == 1``
    (every exit of the pair leaves from v) and ``indeg(v) == 1`` (every
    entry arrives at u) — otherwise a bounded DFS over the
    contracted-so-far graph decides, rejecting on budget exhaustion.
    Returns ``(cluster_of, n_clusters)`` with clusters numbered by
    ascending smallest member.
    """
    s_indptr, s_dst, s_cost, p_indptr, _p_src, _p_cost, work = level
    n = len(work)
    e_src = _edge_endpoints(s_indptr)
    order = np.lexsort((s_dst, e_src, -s_cost))
    es = e_src[order].tolist()
    ed = s_dst[order].tolist()
    si = s_indptr.tolist()
    sd = s_dst.tolist()
    outdeg = np.diff(s_indptr).tolist()
    indeg = np.diff(p_indptr).tolist()
    work_l = work.tolist()
    mate = [-1] * n
    for idx in range(len(es)):
        u = es[idx]
        if mate[u] != -1:
            continue
        v = ed[idx]
        if mate[v] != -1:
            continue
        if work_l[u] + work_l[v] > max_cluster:
            continue
        if outdeg[u] == 1 or indeg[v] == 1 or \
                _no_alternative_path(u, v, si, sd, mate):
            mate[u] = v
            mate[v] = u
    cid = np.empty(n, dtype=np.int64)
    nc = 0
    for u in range(n):
        m = mate[u]
        if m == -1 or m > u:
            cid[u] = nc
            if m != -1:
                cid[m] = nc
            nc += 1
    return cid, nc


def _contract_level(level: tuple, cid: np.ndarray, nc: int) -> tuple:
    """The quotient of ``level`` under ``cid`` (vectorized build)."""
    s_indptr, s_dst, s_cost, _pi, _ps, _pc, work = level
    e_src = _edge_endpoints(s_indptr)
    cwork = np.bincount(cid, weights=work, minlength=nc)
    eu = cid[e_src]
    ev = cid[s_dst]
    keep = eu != ev
    key = eu[keep] * np.int64(nc) + ev[keep]
    uniq, inv = np.unique(key, return_inverse=True)
    ccost = np.bincount(inv, weights=s_cost[keep])
    cu = (uniq // nc).astype(np.int64)
    cv = (uniq % nc).astype(np.int64)
    cs_indptr = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(np.bincount(cu, minlength=nc), out=cs_indptr[1:])
    po = np.lexsort((cu, cv))
    cp_indptr = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(np.bincount(cv, minlength=nc), out=cp_indptr[1:])
    return (cs_indptr, cv, ccost, cp_indptr, cu[po], ccost[po], cwork)


def _level_lists(level: tuple) -> tuple:
    """A level's CSR adjacency converted to plain lists."""
    return (level[0].tolist(), level[1].tolist(), level[2].tolist(),
            level[3].tolist(), level[4].tolist(), level[5].tolist())


def _csr_locality_order(level: tuple) -> list[int]:
    """The locality topo order of a level (array-backed Kahn)."""
    s_indptr, s_dst, _sc, p_indptr, p_src, _pc, work = level
    n = len(work)
    si = s_indptr.tolist()
    sd = s_dst.tolist()
    pi = p_indptr.tolist()
    ps = p_src.tolist()
    indeg = [pi[u + 1] - pi[u] for u in range(n)]
    pos = [-1] * n
    heap = [(0, u) for u in range(n) if indeg[u] == 0]
    heapq.heapify(heap)
    order: list[int] = []
    while heap:
        _, u = heapq.heappop(heap)
        pos[u] = len(order)
        order.append(u)
        for j in range(si[u], si[u + 1]):
            v = sd[j]
            indeg[v] -= 1
            if indeg[v] == 0:
                last = max(pos[ps[jj]] for jj in range(pi[v], pi[v + 1]))
                heapq.heappush(heap, (-last, v))
    if len(order) != n:
        raise ValueError("coarse level is cyclic — contraction bug")
    return order


def _partition_level(level: tuple, k: int, eps: float,
                     passes: int) -> np.ndarray:
    """Split-and-refine one level; returns a compact block array."""
    work = level[6]
    nl = len(work)
    k = max(1, min(k, nl))
    order = _csr_locality_order(level)
    work_l = work.tolist()
    total = sum(work_l[u] for u in order) or float(nl)
    block_of, k_eff = _contiguous_split(order, work_l, total, k)
    if k_eff > 1:
        arrs = (_edge_endpoints(level[0]), level[1], level[2],
                _edge_endpoints(level[3]), level[4], level[5])
        b_arr = np.fromiter(block_of, dtype=np.int64, count=nl)
        weights = np.bincount(b_arr, weights=work,
                              minlength=k_eff).tolist()
        counts = np.bincount(b_arr, minlength=k_eff).tolist()
        cap = (1.0 + eps) * (total / k_eff)
        moves, passes_run = _refine_csr(
            _level_lists(level), arrs, work_l, block_of,
            k_eff, weights, counts, cap, passes)
        counters.bump("step1_moves", moves)
        counters.bump("step1_passes", passes_run)
    block = np.fromiter(block_of, dtype=np.int64, count=nl)
    used = np.unique(block)
    return np.searchsorted(used, block)


def _multilevel_partition(
    wf: Workflow, k: int, eps: float, passes: int
) -> list[int]:
    counters.bump("step1_multilevel_calls")
    fv = _flat_view(wf)
    work = np.asarray(wf.work, dtype=np.float64)
    total = float(work.sum()) or float(wf.n)
    levels = [(fv.s_indptr, fv.s_dst, fv.s_cost,
               fv.p_indptr, fv.p_src, fv.p_cost, work)]
    maps: list[np.ndarray] = []
    floor = max(8 * k, _COARSEN_FLOOR)
    max_cluster = total / float(k)
    while len(levels[-1][6]) > floor:
        ln = len(levels[-1][6])
        cid, nc = _coarsen_match(levels[-1], max_cluster)
        if nc > 0.97 * ln:  # matching stalled — coarser won't help
            break
        levels.append(_contract_level(levels[-1], cid, nc))
        maps.append(cid)
    counters.bump("step1_coarsen_levels", len(maps))

    block = _partition_level(levels[-1], k, eps, passes)

    for lvl in range(len(maps) - 1, -1, -1):
        block = block[maps[lvl]]  # project onto the finer level
        level = levels[lvl]
        work_lv = level[6]
        nl = len(work_lv)
        e_src = _edge_endpoints(level[0])
        e_dst = level[1]
        if not bool((block[e_src] <= block[e_dst]).all()):
            raise RuntimeError(
                "multilevel projection broke the topological-id "
                "invariant — coarsening contracted a cycle-creating edge"
            )
        if lvl == 0:
            counters.bump(
                "step1_cut_before",
                int(round(_cut_of(block, e_src, e_dst, level[2]))))
        k_eff = int(block.max()) + 1
        if k_eff > 1:
            block_of = block.tolist()
            work_l = work_lv.tolist()
            weights = np.bincount(block, weights=work_lv,
                                  minlength=k_eff).tolist()
            counts = np.bincount(block, minlength=k_eff).tolist()
            ltotal = float(work_lv.sum()) or float(nl)
            cap = (1.0 + eps) * (ltotal / k_eff)
            if lvl == 0:
                lists, arrs = _csr_lists(wf, fv)
            else:
                lists = _level_lists(level)
                arrs = (e_src, e_dst, level[2],
                        _edge_endpoints(level[3]), level[4], level[5])
            moves, passes_run = _refine_csr(
                lists, arrs, work_l, block_of, k_eff,
                weights, counts, cap, passes)
            counters.bump("step1_moves", moves)
            counters.bump("step1_passes", passes_run)
            block = np.fromiter(block_of, dtype=np.int64, count=nl)
        used = np.unique(block)
        if len(used) != k_eff:
            block = np.searchsorted(used, block)
        if lvl == 0:
            counters.bump(
                "step1_cut_after",
                int(round(_cut_of(block, e_src, e_dst, level[2]))))
    return block.tolist()


# ---------------------------------------------------------------------- #
# public entry points
# ---------------------------------------------------------------------- #
def acyclic_partition(
    wf: Workflow,
    k: int,
    *,
    eps: float = 0.2,
    passes: int = 4,
    multilevel: bool = False,
) -> list[int]:
    """Acyclic ``k``-way partition of ``wf`` (block ids ``0..k'-1``).

    May return fewer than ``k`` non-empty blocks when ``wf.n < k``
    (paper: the partitioner cannot always reach the requested count).
    Block ids respect topological order: for every edge ``(u, v)``,
    ``block_of[u] <= block_of[v]``.

    ``multilevel=True`` opts into coarsen→partition→uncoarsen (dagP
    shape) for large graphs — it changes cuts (usually for the better
    at n ≥ 10⁵) and is therefore never chosen implicitly; small graphs
    fall through to the single-level path.  The single-level result is
    bit-identical across :func:`set_step1_impl` modes.
    """
    n = wf.n
    if n == 0:
        return []
    k = max(1, min(k, n))
    if multilevel and n >= 2 * max(8 * k, _COARSEN_FLOOR):
        return _multilevel_partition(wf, k, eps, passes)
    if _use_flat(n):
        return _acyclic_partition_flat(wf, k, eps, passes)
    return _acyclic_partition_scalar(wf, k, eps, passes)


def partition_block(
    wf: Workflow,
    nodes: Sequence[int],
    parts: int,
    *,
    eps: float = 0.2,
) -> list[list[int]]:
    """Partition a block of ``wf`` into up to ``parts`` sub-blocks.

    Used by the heuristic's FitBlock (paper Algorithm 2).  Returns the
    sub-blocks as lists of *original* task ids (≥ 1 sub-blocks; may be
    fewer than ``parts`` for tiny blocks, may be more only never —
    unlike dagP we control the split exactly, but callers still treat
    the result as "one or more blocks").  Goes through the same
    scalar/flat dispatch as :func:`acyclic_partition`, so large
    FitBlock splits ride the flat path too.
    """
    nodes = list(nodes)
    if len(nodes) <= 1 or parts <= 1:
        return [nodes]
    sub, mapping = wf.subgraph(nodes)
    assignment = acyclic_partition(sub, parts, eps=eps)
    groups: dict[int, list[int]] = {}
    for i, b in enumerate(assignment):
        groups.setdefault(b, []).append(mapping[i])
    if len(groups) == 1:
        # safety net: callers (FitBlock) rely on strict progress — fall
        # back to a topological midpoint split.
        order = _locality_topo_order(sub)
        half = len(order) // 2
        first = {order[i] for i in range(half)}
        return [
            [mapping[i] for i in sorted(first)],
            [mapping[i] for i in range(sub.n) if i not in first],
        ]
    return [groups[b] for b in sorted(groups)]
