"""Peak-memory traversal of (sub-)workflows — the paper's MemDag role.

The paper computes a block's memory requirement ``r_{V_i}`` with MemDag
(Kayaaslan et al. 2018): SP-ize the block, then find the traversal with
minimum peak memory.  Exact minimum-peak traversal of a general DAG is
NP-hard, so this module provides (DESIGN.md §3.3):

* :func:`simulate_peak` — peak memory of a *given* sequential order,
* :func:`exact_min_peak` — exact minimum over all topological orders via
  DP on downward-closed subsets (used for blocks ≤ ``EXACT_LIMIT`` tasks
  and as the oracle in property tests),
* :func:`greedy_min_peak` — best-first heuristic for larger blocks,
* :func:`block_requirement` — public entry point used by the heuristics.

Memory model (sequential execution of one block on one processor):

* an internal file ``c[u,v]`` occupies memory from the start of ``u``
  until the completion of ``v``;
* an *external input* (edge from another block) is materialized when its
  consumer starts and freed when it completes (it streams in on demand);
* an *external output* occupies memory while its producer runs and is
  freed right after (it is sent to the consuming block's processor);
* while task ``u`` runs, its own footprint ``m_u`` is added.

Hence, with ``live(S)`` = Σ internal ``c[a,b]``, ``a ∈ S``, ``b ∉ S``::

    mem_during(u, S) = live(S) + ext_in(u) + m_u + out_total(u)

which is ``live(S)`` plus a per-task constant.  (``out_total`` counts
internal and external outputs; internal inputs are already in ``live``.)
"""
from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np

from . import counters
from .dag import Workflow

__all__ = [
    "simulate_peak",
    "simulate_peak_members",
    "occupancy_steps",
    "exact_min_peak",
    "greedy_min_peak",
    "block_requirement",
    "block_requirement_witness",
    "set_step2_impl",
    "step2_impl",
    "EXACT_LIMIT",
]

EXACT_LIMIT = 14

#: Step-2 block-constant implementation: "auto" dispatches large blocks
#: to the flat-array path and small ones to the scalar path; "scalar" /
#: "flat" force one side (property tests, benchmarks).  Both paths are
#: bit-identical (see docs/architecture.md, "Flat-array Step 2").
_STEP2_IMPL = "auto"

#: blocks below this size stay on the scalar path in "auto" mode — the
#: numpy call overhead only amortizes once the block's edge volume is
#: a few cache lines wide (measured crossover ~tens of tasks).
_FLAT_CUTOVER = 48


def set_step2_impl(mode: str) -> str:
    """Select the Step-2 implementation; returns the previous mode.

    ``"auto"`` (default) uses the flat-array path for blocks of at
    least ``_FLAT_CUTOVER`` tasks and the scalar path below;
    ``"scalar"`` / ``"flat"`` force one implementation everywhere.
    Results are bit-identical in every mode (asserted by
    ``tests/test_step2_flat.py``); the knob exists for benchmarks
    (``make bench-large`` records the scalar-vs-flat Step-2 share
    under ``"step2"`` in ``BENCH_runtime.json``) and property tests.
    """
    global _STEP2_IMPL
    if mode not in ("auto", "scalar", "flat"):
        raise ValueError(f"unknown Step-2 impl {mode!r}")
    prev = _STEP2_IMPL
    _STEP2_IMPL = mode
    return prev


def step2_impl() -> str:
    """The currently selected Step-2 implementation mode."""
    return _STEP2_IMPL


def _use_flat(n: int) -> bool:
    """Shared dispatch predicate of the two Step-2 entry points."""
    if _STEP2_IMPL == "flat":
        return True
    return _STEP2_IMPL == "auto" and n >= _FLAT_CUTOVER


# ---------------------------------------------------------------------- #
# flat-array workflow view (Step-2 hot path)
# ---------------------------------------------------------------------- #
class _FlatWorkflow:
    """Immutable CSR snapshot of a workflow plus per-task scratch.

    Step 2's FitBlock recursion prices thousands of blocks of the same
    workflow; rebuilding per-task ``during``/``delta`` constants from
    the adjacency dicts per block is the remaining O(E)-per-split cost
    the ROADMAP names.  This view stores the adjacency once as flat
    arrays — successor CSR in ``(task ascending, dict insertion)``
    order, predecessor CSR in ``(task ascending, dict insertion)``
    order — and computes any block's constants with a handful of
    vectorized gathers and ``np.bincount`` accumulations.

    Bit-identity: ``np.bincount`` adds its weights sequentially in
    input order, and the edge lists are gathered in exactly the order
    the scalar loops visit the dicts, so every per-task float
    accumulates with the same association as the scalar path.

    ``stamp`` / ``local`` are global per-task vectors reused across
    blocks (token-stamped membership + local ids): switching blocks is
    O(block), never O(n) — the "maintain global per-task vectors under
    FitBlock splits" design.  The shared scratch makes the view
    single-threaded per Workflow object (like every mutable cache on
    it); the parallel k' sweep isolates by *process*, never by thread.
    """

    __slots__ = (
        "n", "s_indptr", "s_dst", "s_cost", "p_indptr", "p_src",
        "p_cost", "mem", "out_total", "stamp", "local", "_token",
    )

    def __init__(self, wf: Workflow) -> None:
        n = wf.n
        self.n = n
        m = wf.n_edges
        s_indptr = np.zeros(n + 1, dtype=np.int64)
        s_dst = np.empty(m, dtype=np.int64)
        s_cost = np.empty(m, dtype=np.float64)
        k = 0
        for u in range(n):
            for v, c in wf.succ[u].items():
                s_dst[k] = v
                s_cost[k] = c
                k += 1
            s_indptr[u + 1] = k
        p_indptr = np.zeros(n + 1, dtype=np.int64)
        p_src = np.empty(m, dtype=np.int64)
        p_cost = np.empty(m, dtype=np.float64)
        k = 0
        for v in range(n):
            for u, c in wf.pred[v].items():
                p_src[k] = u
                p_cost[k] = c
                k += 1
            p_indptr[v + 1] = k
        self.s_indptr, self.s_dst, self.s_cost = s_indptr, s_dst, s_cost
        self.p_indptr, self.p_src, self.p_cost = p_indptr, p_src, p_cost
        self.mem = np.asarray(wf.mem, dtype=np.float64)
        # total outbound volume per task, accumulated in succ-dict
        # order (bincount is sequential) — matches the scalar loops
        self.out_total = np.bincount(
            np.repeat(np.arange(n, dtype=np.int64), np.diff(s_indptr)),
            weights=s_cost, minlength=n)
        self.stamp = np.zeros(n, dtype=np.int64)
        self.local = np.zeros(n, dtype=np.int64)
        self._token = 0

    def mark(self, nodes: np.ndarray) -> int:
        """Stamp ``nodes`` as the current block; returns the token."""
        self._token += 1
        self.stamp[nodes] = self._token
        self.local[nodes] = np.arange(len(nodes), dtype=np.int64)
        return self._token


def _flat_view(wf: Workflow) -> _FlatWorkflow:
    """The workflow's cached :class:`_FlatWorkflow` (built on demand).

    Shared by Step 2 and the Step-1 flat partitioner (its CSR edge
    order *is* the scalar iteration order, which is what makes the
    replayed float accumulations bit-identical).  Cache validity is
    guarded by ``(n, n_edges)`` (both O(1)): workflows are static
    during a scheduling run, and :meth:`Workflow.add_edge` drops the
    view explicitly when it accumulates onto an existing edge (the one
    mutation this guard cannot see).  Helpers that rewrite weights of
    *existing* tasks or edges in place must do the same (the workflow
    generators do).
    """
    cached = getattr(wf, "_flat_cache", None)
    if cached is not None:
        n, m, fv = cached
        if n == wf.n and m == wf.n_edges:
            return fv
    fv = _FlatWorkflow(wf)
    wf._flat_cache = (wf.n, wf.n_edges, fv)
    return fv


def _gather_rows(indptr: np.ndarray, rows: np.ndarray):
    """``(edge_idx, row_of_edge)`` for the CSR slices of ``rows``.

    ``edge_idx`` concatenates each row's ``indptr`` range in row
    order; ``row_of_edge[j]`` is the local row index owning edge j.
    """
    counts = indptr[rows + 1] - indptr[rows]
    rep = np.repeat(np.arange(len(rows), dtype=np.int64), counts)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), rep
    ends = np.cumsum(counts)
    idx = np.arange(total, dtype=np.int64) + np.repeat(
        indptr[rows] - (ends - counts), counts)
    return idx, rep


def _constants(
    sub: Workflow,
    ext_in: dict[int, float],
    ext_out: dict[int, float],
) -> tuple[list[float], list[float]]:
    """Per-task ``(during_const, live_delta)``.

    ``during_const[u]``: what task ``u`` adds on top of ``live(S)`` while
    it runs.  ``live_delta[u]``: change of the internal live set after
    ``u`` completes (internal outputs appear, internal inputs freed).
    """
    during = [0.0] * sub.n
    delta = [0.0] * sub.n
    for u in range(sub.n):
        int_in = sub.in_cost(u)
        int_out = sub.out_cost(u)
        during[u] = (
            ext_in.get(u, 0.0) + sub.mem[u] + int_out + ext_out.get(u, 0.0)
        )
        delta[u] = int_out - int_in
    return during, delta


def simulate_peak(
    sub: Workflow,
    order: Sequence[int],
    ext_in: dict[int, float] | None = None,
    ext_out: dict[int, float] | None = None,
) -> float:
    """Peak memory of executing ``sub`` sequentially in ``order``."""
    ext_in = ext_in or {}
    ext_out = ext_out or {}
    during, delta = _constants(sub, ext_in, ext_out)
    live = 0.0
    peak = 0.0
    done = [False] * sub.n
    for u in order:
        if any(not done[p] for p in sub.pred[u]):
            raise ValueError("order violates precedence constraints")
        peak = max(peak, live + during[u])
        live += delta[u]
        done[u] = True
    if not all(done):
        raise ValueError("order does not cover the block")
    return peak


def occupancy_steps(wf: Workflow, members, order: Sequence[int]):
    """Yield ``(u, during, live_after)`` along a block traversal.

    The single source of truth for the transient-occupancy
    accumulation over the original workflow (no subgraph/boundary
    materialization), with edges leaving or entering ``members``
    treated as external per the module memory model: ``during`` is the
    occupancy while ``u`` runs, ``live_after`` the internal live set
    once it completes.  Shared by the witness evaluator below and the
    simulator's time-resolved memory tracker
    (:mod:`repro_torch.sim.memory`), which must price states bit-identically
    to :func:`block_requirement`.  ``order`` must cover ``members``
    exactly and respect precedence *within* the block (not checked —
    this is the hot path; :func:`simulate_peak` is the checked
    variant).  Excludes the persistent base (callers add Σ persistent).
    """
    members = members if isinstance(members, (set, frozenset)) \
        else set(members)
    live = 0.0
    for u in order:
        int_in = 0.0
        ext_in = 0.0
        for p, c in wf.pred[u].items():
            if p in members:
                int_in += c
            else:
                ext_in += c
        int_out = 0.0
        out_total = 0.0
        for v, c in wf.succ[u].items():
            out_total += c
            if v in members:
                int_out += c
        during = live + ext_in + wf.mem[u] + out_total
        live += int_out - int_in
        yield u, during, live


def simulate_peak_members(
    wf: Workflow,
    members,
    order: Sequence[int],
) -> float:
    """Transient peak of executing block ``members`` of ``wf`` in
    ``order`` — ``max`` over the :func:`occupancy_steps` states (see
    there for the memory model and the unchecked-precedence caveat).

    ``order`` must cover ``members`` exactly (already an
    :func:`occupancy_steps` precondition); large blocks dispatch to a
    flat-array evaluation that is bit-identical to the scalar loop
    (same accumulation order — see :class:`_FlatWorkflow`).
    """
    if _use_flat(len(order)):
        return _simulate_peak_members_flat(wf, order)
    counters.bump("step2_scalar_peak_sims")
    peak = 0.0
    for _, during, _ in occupancy_steps(wf, members, order):
        if during > peak:
            peak = during
    return peak


def _simulate_peak_members_flat(wf: Workflow, order: Sequence[int]) -> float:
    """Flat-array :func:`simulate_peak_members` (identical floats).

    ``live`` is the sequential prefix sum of the per-task deltas
    (``np.cumsum`` accumulates left to right, like the scalar loop)
    and every per-task constant sums its edge contributions in the
    scalar visiting order via ``np.bincount``.
    """
    counters.bump("step2_flat_peak_sims")
    nb = len(order)
    if nb == 0:
        return 0.0
    fv = _flat_view(wf)
    order_arr = np.asarray(order, dtype=np.int64)
    token = fv.mark(order_arr)
    pidx, prep = _gather_rows(fv.p_indptr, order_arr)
    internal_p = fv.stamp[fv.p_src[pidx]] == token
    pcost = fv.p_cost[pidx]
    int_in = np.bincount(prep[internal_p], weights=pcost[internal_p],
                         minlength=nb)
    ext_in = np.bincount(prep[~internal_p], weights=pcost[~internal_p],
                         minlength=nb)
    sidx, srep = _gather_rows(fv.s_indptr, order_arr)
    internal_s = fv.stamp[fv.s_dst[sidx]] == token
    int_out = np.bincount(srep[internal_s],
                          weights=fv.s_cost[sidx][internal_s],
                          minlength=nb)
    live = np.empty(nb, dtype=np.float64)
    live[0] = 0.0
    if nb > 1:
        np.cumsum((int_out - int_in)[:-1], out=live[1:])
    during = ((live + ext_in) + fv.mem[order_arr]) + fv.out_total[order_arr]
    peak = float(during.max())
    return peak if peak > 0.0 else 0.0


def exact_min_peak(
    sub: Workflow,
    ext_in: dict[int, float] | None = None,
    ext_out: dict[int, float] | None = None,
) -> float:
    """Exact minimum peak memory over all topological orders (DP).

    State: downward-closed subset ``S`` of executed tasks (bitmask).
    ``live(S)`` only depends on ``S``, so
    ``f(S) = min_{u ready into S} max(f(S \\ u), live(S \\ u) + during(u))``.
    Exponential — gate on ``sub.n <= ~20`` at call sites.
    """
    ext_in = ext_in or {}
    ext_out = ext_out or {}
    n = sub.n
    if n == 0:
        return 0.0
    during, delta = _constants(sub, ext_in, ext_out)
    pred_mask = [0] * n
    for v in range(n):
        for p in sub.pred[v]:
            pred_mask[v] |= 1 << p
    full = (1 << n) - 1
    # frontier DP over popcount layers; store live alongside to avoid
    # recomputation (live is additive in deltas of members).
    f: dict[int, float] = {0: 0.0}
    live: dict[int, float] = {0: 0.0}
    for _ in range(n):
        nf: dict[int, float] = {}
        nlive: dict[int, float] = {}
        for S, peak in f.items():
            lS = live[S]
            for u in range(n):
                bit = 1 << u
                if S & bit or (pred_mask[u] & S) != pred_mask[u]:
                    continue
                S2 = S | bit
                cand = max(peak, lS + during[u])
                old = nf.get(S2)
                if old is None or cand < old:
                    nf[S2] = cand
                    nlive[S2] = lS + delta[u]
        f, live = nf, nlive
    return f[full]


def greedy_min_peak(
    sub: Workflow,
    ext_in: dict[int, float] | None = None,
    ext_out: dict[int, float] | None = None,
    return_order: bool = False,
):
    """Best-first heuristic traversal minimizing peak memory.

    Two ready-heaps: tasks that *shrink* the live set (scheduled first,
    by smallest transient footprint) and tasks that grow it.  Because
    ``mem_during`` is ``live + const(u)``, ordering ready tasks by
    ``const(u)`` is time-invariant, giving O(E log V).

    A final *peak-shaving* pass re-simulates with the classic
    "largest-freeing first among below-peak" tie-break and keeps the
    better of the two traversals.
    """
    ext_in = ext_in or {}
    ext_out = ext_out or {}
    n = sub.n
    if n == 0:
        return (0.0, []) if return_order else 0.0
    during, delta = _constants(sub, ext_in, ext_out)

    def run(key) -> tuple[float, list[int]]:
        indeg = [len(sub.pred[u]) for u in range(n)]
        heap = [(key(u), u) for u in range(n) if indeg[u] == 0]
        heapq.heapify(heap)
        live = peak = 0.0
        order: list[int] = []
        while heap:
            _, u = heapq.heappop(heap)
            peak = max(peak, live + during[u])
            live += delta[u]
            order.append(u)
            for v in sub.succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    heapq.heappush(heap, (key(v), v))
        return peak, order

    # variant 1: memory-freeing tasks first, then smallest footprint
    p1, o1 = run(lambda u: (delta[u] >= 0, during[u], u))
    # variant 2: smallest transient footprint outright
    p2, o2 = run(lambda u: (during[u], delta[u], u))
    peak, order = (p1, o1) if p1 <= p2 else (p2, o2)
    return (peak, order) if return_order else peak


def greedy_min_peak_members(
    wf: Workflow,
    nodes: Sequence[int],
) -> tuple[float, list[int]]:
    """Subgraph-free :func:`greedy_min_peak` over block ``nodes``.

    Produces bit-identical peaks/orders to building the induced
    sub-workflow and running :func:`greedy_min_peak` on it: internal
    input volumes accumulate in the sub-``add_edge`` order (producers
    in ``nodes`` order), the ``during`` sum uses the same association,
    and heap tie-breaks use the position in ``nodes`` (the local id of
    the subgraph construction).  Avoiding the Workflow materialization
    is what keeps Step 2's recursive splitting and the requirement
    cache misses affordable at 30k tasks.

    Dispatches by block size between two bit-identical
    implementations (see :func:`set_step2_impl`): the scalar
    dict-walking reference below and the flat-array path
    (:func:`_greedy_min_peak_members_flat`) that computes the block
    constants with vectorized gathers and runs the ready-heap on
    lexsort ranks.
    """
    n = len(nodes)
    if n == 0:
        return 0.0, []
    if _use_flat(n):
        return _greedy_min_peak_members_flat(wf, nodes)
    return _greedy_min_peak_members_scalar(wf, nodes)


def _greedy_min_peak_members_scalar(
    wf: Workflow,
    nodes: Sequence[int],
) -> tuple[float, list[int]]:
    """Scalar reference implementation of
    :func:`greedy_min_peak_members` (also the fast path for small
    blocks, where numpy call overhead dominates)."""
    counters.bump("step2_scalar_blocks")
    n = len(nodes)
    if n == 0:
        return 0.0, []
    local = {u: i for i, u in enumerate(nodes)}
    during = [0.0] * n
    delta = [0.0] * n
    indeg = [0] * n
    int_in = [0.0] * n
    # internal input volume, accumulated in subgraph add_edge order
    for u in nodes:
        for v, c in wf.succ[u].items():
            j = local.get(v)
            if j is not None:
                int_in[j] += c
    for i, u in enumerate(nodes):
        int_out = 0.0
        ext_out = 0.0
        for v, c in wf.succ[u].items():
            if v in local:
                int_out += c
            else:
                ext_out += c
        ext_in = 0.0
        for v, c in wf.pred[u].items():
            if v in local:
                indeg[i] += 1
            else:
                ext_in += c
        during[i] = ext_in + wf.mem[u] + int_out + ext_out
        delta[i] = int_out - int_in[i]

    succ_local: list[list[int]] = [
        [j for v in wf.succ[u] if (j := local.get(v)) is not None]
        for u in nodes
    ]

    def run(keys: list[tuple]) -> tuple[float, list[int]]:
        deg = list(indeg)
        heap = [(keys[i], i) for i in range(n) if deg[i] == 0]
        heapq.heapify(heap)
        live = peak = 0.0
        order: list[int] = []
        heappush, heappop = heapq.heappush, heapq.heappop
        while heap:
            _, i = heappop(heap)
            d = live + during[i]
            if d > peak:
                peak = d
            live += delta[i]
            order.append(i)
            for j in succ_local[i]:
                deg[j] -= 1
                if deg[j] == 0:
                    heappush(heap, (keys[j], j))
        return peak, order

    p1, o1 = run([(delta[i] >= 0, during[i], i) for i in range(n)])
    # any traversal peaks at least max(during) (live is nonnegative);
    # when variant 1 attains that bound, variant 2 cannot do better and
    # the tie-break keeps (p1, o1) anyway — skip the second run.
    if p1 > max(during):
        p2, o2 = run([(during[i], delta[i], i) for i in range(n)])
        if p2 < p1:
            return p2, [nodes[i] for i in o2]
    return p1, [nodes[i] for i in o1]


def _greedy_min_peak_members_flat(
    wf: Workflow,
    nodes: Sequence[int],
) -> tuple[float, list[int]]:
    """Flat-array :func:`greedy_min_peak_members` (identical results).

    Block constants come from the cached :class:`_FlatWorkflow` CSR
    view — vectorized gathers + sequential ``np.bincount``
    accumulation reproduce the scalar float associations exactly — and
    the ready-heap runs on *lexsort ranks*: each variant's key tuples
    ``(flag, during, i)`` are ranked once with ``np.lexsort`` (stable,
    so ties fall back to the local id exactly like the tuple compare)
    and the heap then holds plain ints.  Pops are strictly by minimum
    key in both versions, so the traversal — and hence every
    ``live``/``peak`` float — is bit-identical to the scalar run.
    """
    counters.bump("step2_flat_blocks")
    n = len(nodes)
    fv = _flat_view(wf)
    nodes_arr = np.asarray(nodes, dtype=np.int64)
    token = fv.mark(nodes_arr)
    # successor-side constants (edge order == scalar scan order)
    sidx, srep = _gather_rows(fv.s_indptr, nodes_arr)
    sdst = fv.s_dst[sidx]
    scost = fv.s_cost[sidx]
    internal_s = fv.stamp[sdst] == token
    int_cost = scost[internal_s]
    int_src = srep[internal_s]
    int_dst = fv.local[sdst[internal_s]]
    int_out = np.bincount(int_src, weights=int_cost, minlength=n)
    ext_out = np.bincount(srep[~internal_s], weights=scost[~internal_s],
                          minlength=n)
    # the scalar path accumulates int_in over producers in ``nodes``
    # order — exactly this (masked) edge sequence
    int_in = np.bincount(int_dst, weights=int_cost, minlength=n)
    # predecessor-side constants
    pidx, prep = _gather_rows(fv.p_indptr, nodes_arr)
    external_p = fv.stamp[fv.p_src[pidx]] != token
    ext_in = np.bincount(prep[external_p],
                         weights=fv.p_cost[pidx][external_p],
                         minlength=n)
    during = ((ext_in + fv.mem[nodes_arr]) + int_out) + ext_out
    delta = int_out - int_in
    if len(int_cost) == 0:
        # Edge-free block (common for fan families and late FitBlock
        # splits): every task is ready from the start, so the heap
        # degenerates to one sort, ``delta == 0`` everywhere keeps
        # ``live`` at 0.0, the peak is exactly ``max(during)``, and
        # the second variant can never beat it (its guard is false).
        perm = np.lexsort((during, delta >= 0))
        peak = float(during.max())
        return (peak if peak > 0.0 else 0.0,
                [nodes[i] for i in perm.tolist()])
    indeg0 = np.bincount(int_dst, minlength=n)
    # local successor CSR (int_src is nondecreasing: grouped by source)
    lptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(int_src, minlength=n), out=lptr[1:])
    lptr_l = lptr.tolist()
    ldst_l = int_dst.tolist()
    during_l = during.tolist()
    delta_l = delta.tolist()
    indeg_l = indeg0.tolist()
    ready0 = indeg0 == 0

    inf = float("inf")

    def run(perm: np.ndarray, cutoff: float = inf) -> tuple[float, list[int]]:
        order_of = perm.tolist()
        rank_of = np.empty(n, dtype=np.int64)
        rank_of[perm] = np.arange(n, dtype=np.int64)
        rank_l = rank_of.tolist()
        deg = list(indeg_l)
        heap = rank_of[ready0].tolist()
        heapq.heapify(heap)
        live = peak = 0.0
        order: list[int] = []
        heappush, heappop = heapq.heappush, heapq.heappop
        while heap:
            i = order_of[heappop(heap)]
            d = live + during_l[i]
            if d > peak:
                peak = d
                if peak >= cutoff:
                    # a traversal's peak only grows: this variant can
                    # no longer beat the incumbent — abort (the caller
                    # discards the partial order on peak >= cutoff)
                    return peak, order
            live += delta_l[i]
            order.append(i)
            for j in ldst_l[lptr_l[i]:lptr_l[i + 1]]:
                deg[j] -= 1
                if deg[j] == 0:
                    heappush(heap, rank_l[j])
        return peak, order

    # variant 1: memory-freeing tasks first, then smallest footprint
    # (np.lexsort: last key is primary; stability supplies the id tie)
    p1, o1 = run(np.lexsort((during, delta >= 0)))
    if p1 > float(during.max()):
        # variant 2: smallest transient footprint outright, aborted as
        # soon as it provably cannot beat variant 1
        p2, o2 = run(np.lexsort((delta, during)), cutoff=p1)
        if p2 < p1:
            return p2, [nodes[i] for i in o2]
    return p1, [nodes[i] for i in o1]


def block_requirement(
    wf: Workflow,
    nodes: Sequence[int],
    exact_limit: int = EXACT_LIMIT,
    return_order: bool = False,
):
    """Memory requirement ``r_{V_i}`` of a block of ``wf``.

    Cross-block edges contribute as external inputs/outputs per the
    module-level memory model.
    """
    nodes = list(nodes)
    # persistent residency (placement layer: weights/caches) adds a
    # traversal-independent base to the block's requirement
    base = sum(wf.persistent[u] for u in nodes)
    if len(nodes) <= exact_limit:
        sub, mapping = wf.subgraph(nodes)
        ext_in, ext_out = wf.boundary_costs(nodes)
        peak = base + exact_min_peak(sub, ext_in, ext_out)
        if not return_order:
            return peak
        # exact DP does not retain the order; fall back to the greedy
        # order (whose simulated peak may be slightly above ``peak``).
        _, order = greedy_min_peak_members(wf, nodes)
        return peak, order
    peak, order = greedy_min_peak_members(wf, nodes)
    if return_order:
        return base + peak, order
    return base + peak


def block_requirement_witness(
    wf: Workflow,
    nodes: Sequence[int],
    exact_limit: int = EXACT_LIMIT,
) -> tuple[float, float, float, list[int]]:
    """``(r, base, peak_w, order)`` — requirement plus traversal witness.

    ``r`` is :func:`block_requirement`'s value (base + min-peak
    estimate); ``base`` the persistent residency; ``order`` a concrete
    traversal of the block (original task ids) whose simulated transient
    peak is ``peak_w``.  For blocks priced by the exact DP, the greedy
    order serves as witness, so ``peak_w`` may exceed ``r - base``.  The
    witness is what makes merged requirements composable: the
    merge-aware cache (:class:`repro_torch.core.heuristic._Requirements`)
    concatenates part witnesses and bounds the result without
    re-running the traversal search.
    """
    nodes = list(nodes)
    base = sum(wf.persistent[u] for u in nodes)
    peak_g, order = greedy_min_peak_members(wf, nodes)
    if len(nodes) <= exact_limit:
        sub, _ = wf.subgraph(nodes)
        ext_in, ext_out = wf.boundary_costs(nodes)
        peak = exact_min_peak(sub, ext_in, ext_out)
        return base + min(peak, peak_g), base, peak_g, order
    return base + peak_g, base, peak_g, order
