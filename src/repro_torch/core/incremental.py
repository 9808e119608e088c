"""Incremental scheduling evaluation for the quotient graph Γ.

The four-step heuristic (``heuristic.py``) explores thousands of
candidate mutations — merges of two blocks (Step 3), processor swaps
and idle moves (Step 4) — and the seed implementation priced every
candidate with a from-scratch bottom-weight sweep: a full topological
sort plus a backward pass over all of Γ per probe.  This module
maintains the bottom weights ``l_ν`` (paper Eq. (1)), the makespan
``max_ν l_ν`` (Eq. (2)) and the critical path *incrementally* under the
three mutations the heuristic actually performs:

* ``set_proc(v, p)``   — processor (re)assignment of one vertex,
* ``merge(a, b)``      — contraction of two vertices (Step 3 trials),
* ``swap(v, w)``       — exchange of two processor assignments.

Invariants
----------
1.  ``l[v] == w_v / s_v + max_{w ∈ succ(v)} (c_vw / β + l[w])`` for
    every vertex of Γ (with the ``s_v = 1`` convention for unassigned
    vertices) whenever the graph is *settled* — i.e. no merge left Γ
    temporarily cyclic.  Values are bit-identical to a from-scratch
    :func:`repro_torch.core.makespan.bottom_weights` sweep: propagation cuts
    off on exact float equality, and per-vertex recomputation applies
    the same arithmetic to the same adjacency dicts.
2.  A mutation only invalidates the bottom weights of the mutated
    vertex and its *ancestors*: descendants' successor subgraphs are
    untouched (a merge rewires only edges incident to the merged
    vertex, and an acyclic merge result cannot place the merged vertex
    below any of its descendants).  Delta propagation therefore walks
    predecessor links only, processing dirty vertices deepest-first
    (by cached topological rank) and stopping as soon as a recomputed
    value is unchanged.
3.  The makespan is served from a lazy max-heap over ``l``: every
    update pushes, queries pop stale entries.  The heap is compacted
    when it outgrows the live vertex set.
4.  Topological ranks are maintained *dynamically*: an acyclic merge
    committed on exact ranks runs a Pearce–Kelly localized reorder
    (``_pk_repair``) — only the affected region between the merged
    vertex and its lowest violating child is reassigned — and the
    acyclicity probe itself is bounded by the same rank window
    (``_cycle_after_merge``).  Full O(V + E) rank refreshes survive
    only for merges applied on top of inexact ranks (committed triple
    merges, whose intermediate state is cyclic).

Transactions
------------
``begin()`` opens a frame; every l-value change, processor change and
merge inside the frame is journalled.  ``rollback()`` restores Γ (LIFO
unmerges) and the exact previous float values; ``commit()`` folds the
journal into the enclosing frame (or drops it at top level).  This is
what makes candidate evaluation with rollback O(affected ancestors)
instead of O(Γ).

A merge that leaves Γ cyclic parks the evaluator in a *broken* state
(``pending`` merges unsettled, makespan queries forbidden) so Step 3
can resolve 2-cycles by a follow-up triple merge before any bottom
weight is touched; ``rollback()`` is the only other exit.
"""
from __future__ import annotations

import heapq
from typing import Iterable

from repro_torch.obs.tracer import current_tracer

from . import counters
from .dag import QuotientGraph
from .makespan import bottom_weights, bottom_weights_flat
from .platform import Platform

__all__ = ["IncrementalEvaluator"]

_MISSING = object()


class _Frame:
    """Journal of one transaction: prior l-values + structural ops."""

    __slots__ = ("lold", "ops", "ranks_exact")

    def __init__(self, ranks_exact: bool) -> None:
        self.lold: dict[int, object] = {}   # vid -> prior l (or _MISSING)
        self.ops: list[tuple] = []          # ("proc", v, old) | ("merge", undo)
        self.ranks_exact = ranks_exact      # flag state to restore on rollback


class IncrementalEvaluator:
    """Maintains bottom weights / makespan / critical path of one Γ.

    All mutations of the quotient graph and of processor assignments
    must go through this object once it is constructed — out-of-band
    edits leave the cached values stale (``rebuild()`` resynchronizes).
    """

    def __init__(self, q: QuotientGraph, platform: Platform) -> None:
        self.q = q
        self.platform = platform
        self.beta = platform.bandwidth
        self._speeds = [p.speed for p in platform.procs]
        self.l: dict[int, float] = {}
        self._heap: list[tuple[float, int]] = []
        self._rank: dict[int, int] = {}
        self._ranks_exact = False
        self._frames: list[_Frame] = []
        self._pending: list[tuple[int, int, int]] = []  # (vm, a, b)
        self._version = 0          # bumped on every l mutation
        self._desc_version = -1    # _values_desc cache tag
        self._desc: list[tuple[float, int]] = []
        self._cp_version = -1      # critical_path cache tag
        self._cp: list[int] = []
        self._cp_set: frozenset[int] = frozenset()
        self._top2_version = -1    # high-degree child-term cache tag
        self._top2: dict[int, tuple] = {}
        #: vertex whose *maintained* bottom weight supplied the
        #: unchanged-part maximum in the last overlay probe's final
        #: check — ``None`` when the probe aborted early or returned a
        #: value.  Step 4's dependency-region verdict cache stores it:
        #: a cached "no improvement" stays valid while this head's
        #: value and the pair's ancestor region are untouched.
        self.last_probe_head: int | None = None
        self.rebuild()

    # -------------------------------------------------------------- #
    # full (re)build — array-driven over a CSR snapshot
    # -------------------------------------------------------------- #
    def rebuild(self) -> None:
        """Recompute everything from scratch (O(V + E))."""
        assert not self._frames and not self._pending
        q = self.q
        order = q.topological_order()
        flat = q.csr_arrays(order)
        lv = bottom_weights_flat(q, self.platform, flat)
        self.l = {v: float(lv[i]) for i, v in enumerate(order)}
        self._rank = {v: i for i, v in enumerate(order)}
        self._ranks_exact = True
        self._heap = [(-x, v) for v, x in self.l.items()]
        heapq.heapify(self._heap)
        self._version += 1

    def refresh_ranks(self) -> None:
        """Recompute exact topological ranks from scratch (O(V + E)).

        With the Pearce–Kelly repair (:meth:`_pk_repair`) committed
        merges keep ranks exact in O(affected region), so this full
        refresh only runs when exactness was lost some other way —
        today that is a settled *triple* merge (the intermediate state
        is cyclic, so no valid ranks exist to repair from).  Bounded
        probes require exact ranks: every vertex is then recomputed
        exactly once per propagation, from settled children, so an
        intermediate value ``>= bound`` proves the final makespan is
        too.
        """
        assert not self._pending
        counters.bump("rank_full_refreshes")
        self._rank = {
            v: i for i, v in enumerate(self.q.topological_order_fast())
        }
        self._ranks_exact = True

    def ensure_exact_ranks(self) -> None:
        """Refresh ranks only if a structural change invalidated them."""
        if not self._ranks_exact:
            self.refresh_ranks()

    # -------------------------------------------------------------- #
    # queries
    # -------------------------------------------------------------- #
    def makespan(self) -> float:
        """Current makespan (Eq. (2)); O(1) amortized."""
        assert not self._pending, "makespan queried on a cyclic (broken) Γ"
        heap, l = self._heap, self.l
        while heap:
            negl, v = heap[0]
            if l.get(v) == -negl:
                return -negl
            heapq.heappop(heap)
        return 0.0

    def argmax(self) -> int | None:
        """Vertex attaining the makespan (None on empty Γ)."""
        self.makespan()
        return self._heap[0][1] if self._heap else None

    def critical_path(self) -> list[int]:
        """Chain realizing the makespan, from the maintained weights.

        Cached between mutations (Step 3 walks it once per queue item,
        but it only changes when some bottom weight does).
        """
        if self._cp_version == self._version:
            return self._cp
        v = self.argmax()
        if v is None:
            path: list[int] = []
        else:
            succ, beta, l = self.q.succ, self.beta, self.l
            path = [v]
            while succ[v]:
                best = None
                bestval = -float("inf")
                for w, c in succ[v].items():
                    val = c / beta + l[w]
                    if val > bestval:
                        bestval = val
                        best = w
                v = best
                path.append(v)
        self._cp = path
        self._cp_set = frozenset(path)
        self._cp_version = self._version
        return path

    def critical_path_set(self) -> frozenset[int]:
        """The critical path as a set (cached with the path itself)."""
        self.critical_path()
        return self._cp_set

    def bottom_weight(self, v: int) -> float:
        return self.l[v]

    def own_time(self, v: int) -> float:
        """``w_v / s_v`` under the current assignment (1.0 unassigned)."""
        return self._own(v)

    # -------------------------------------------------------------- #
    # transactions
    # -------------------------------------------------------------- #
    def begin(self) -> None:
        assert not self._pending, "cannot open a frame on a broken Γ"
        self._frames.append(_Frame(self._ranks_exact))

    def commit(self) -> None:
        assert not self._pending, "cannot commit a broken Γ"
        frame = self._frames.pop()
        if self._frames:
            parent = self._frames[-1]
            for v, old in frame.lold.items():
                parent.lold.setdefault(v, old)
            parent.ops.extend(frame.ops)

    def rollback(self) -> None:
        """Undo every mutation of the innermost frame (exact floats)."""
        frame = self._frames.pop()
        self._pending.clear()
        self._ranks_exact = frame.ranks_exact
        self._version += 1
        q = self.q
        for op in reversed(frame.ops):
            if op[0] == "proc":
                _, v, old = op
                q.proc[v] = old
            elif op[0] == "ranks":  # Pearce–Kelly repair inside a frame
                for v, old in op[1]:
                    self._rank[v] = old
            else:  # ("merge", undo)
                undo = op[1]
                self._rank.pop(undo["vm"], None)
                q.unmerge(undo)
        for v, old in frame.lold.items():
            if old is _MISSING:
                self.l.pop(v, None)
            else:
                self.l[v] = old
                heapq.heappush(self._heap, (-old, v))
        self._compact_if_needed()

    # -------------------------------------------------------------- #
    # mutations
    # -------------------------------------------------------------- #
    def set_proc(self, v: int, p: int | None) -> None:
        """(Re)assign vertex ``v``; propagates deltas to ancestors."""
        assert not self._pending, "set_proc on a cyclic (broken) Γ"
        old = self.q.proc[v]
        if old == p:
            return
        if self._frames:
            self._frames[-1].ops.append(("proc", v, old))
        self.q.proc[v] = p
        self._version += 1
        self._propagate((v,))

    def swap(self, v: int, w: int) -> None:
        """Exchange the processors of ``v`` and ``w``."""
        pv, pw = self.q.proc[v], self.q.proc[w]
        self.set_proc(v, pw)
        self.set_proc(w, pv)

    def swap_and_changes(self, v: int, w: int) -> list[int]:
        """:meth:`swap`, returning the vids whose bottom weight moved.

        Step 4's probe-verdict cache needs the *change set* of an
        applied swap to invalidate only the pairs whose dependency
        region was touched.  Implemented as a throwaway top-level
        transaction: the frame journal already records exactly the
        vertices whose ``l`` changed, and committing at top level
        discards it without further cost.  (``v``/``w`` themselves may
        be absent when the swap left every bottom weight unchanged —
        callers must still treat their *processor* change as a
        mutation.)
        """
        self.begin()
        self.swap(v, w)
        changed = list(self._frames[-1].lold)
        self.commit()
        return changed

    # -------------------------------------------------------------- #
    # bounded probes (Step 4 hot path)
    # -------------------------------------------------------------- #
    def probe_swap(self, v: int, w: int, bound: float) -> float | None:
        """Makespan after swapping ``v``/``w``, or None if ``>= bound``.

        Side-effect-free trial: new values live in an overlay dict, the
        maintained state is never touched (no heap churn, no rollback).
        Requires exact ranks (:meth:`refresh_ranks`) — the propagation
        abort is then an exact rejection, so None means "provably no
        better than ``bound``", never a false negative.
        """
        # per-probe spans are *opt-in* (Tracer.probe_spans): probes fire
        # tens of thousands of times per sweep, so even span-on-trace
        # would blow the enabled-overhead budget
        tr = current_tracer()
        if tr is not None and tr.probe_spans:
            with tr.span("probe.swap", v=v, w=w) as sp:
                ms = self._probe_swap(v, w, bound)
                sp.attrs["beats_bound"] = ms is not None
                return ms
        return self._probe_swap(v, w, bound)

    def _probe_swap(self, v: int, w: int, bound: float) -> float | None:
        proc = self.q.proc
        pv, pw = proc[v], proc[w]
        proc[v], proc[w] = pw, pv
        try:
            return self._overlay_probe((v, w), bound)
        finally:
            proc[v], proc[w] = pv, pw

    def probe_move(self, v: int, p: int | None, bound: float) -> float | None:
        """Makespan after assigning ``v`` to ``p``, or None if ``>= bound``."""
        tr = current_tracer()
        if tr is not None and tr.probe_spans:
            with tr.span("probe.move", v=v, p=p) as sp:
                ms = self._probe_move(v, p, bound)
                sp.attrs["beats_bound"] = ms is not None
                return ms
        return self._probe_move(v, p, bound)

    def _probe_move(self, v: int, p: int | None,
                    bound: float) -> float | None:
        proc = self.q.proc
        pv = proc[v]
        proc[v] = p
        try:
            return self._overlay_probe((v,), bound)
        finally:
            proc[v] = pv

    def probe_merge(
        self,
        a: int,
        b: int,
        proc: int,
        bound: float,
    ) -> float | None:
        """Makespan after merging ``a``/``b`` onto ``proc``, or None.

        Structure-only trial: Γ is merged, priced through the overlay
        (bottom weights untouched), and unmerged before returning.
        None means the merge leaves Γ cyclic or provably cannot beat
        ``bound``.  Callers must rule out 2-cycles beforehand (this
        probe cannot escalate to a triple merge) and guarantee exact
        ranks, as for the other probes.
        """
        tr = current_tracer()
        if tr is not None and tr.probe_spans:
            with tr.span("probe.merge", a=a, b=b, proc=proc) as sp:
                ms = self._probe_merge(a, b, proc, bound)
                sp.attrs["beats_bound"] = ms is not None
                return ms
        return self._probe_merge(a, b, proc, bound)

    def _probe_merge(self, a: int, b: int, proc: int,
                     bound: float) -> float | None:
        q = self.q
        # the rank-windowed cycle probe (not just the bounded overlay)
        # is only sound on exact ranks — fail loudly, not wrongly
        assert self._ranks_exact, "probe_merge requires exact ranks"
        # prime the l-derived caches before the structural trial: built
        # mid-trial they would snapshot the merged adjacency under an
        # unchanged version tag and go stale after the unmerge
        self._top2_terms()
        self._values_desc()
        rv = max(self._rank.get(a, 0), self._rank.get(b, 0))
        vm, undo = q.merge(a, b)
        self._rank[vm] = rv
        ms: float | None = None
        if self._cycle_after_merge(vm, rv) is None:
            q.proc[vm] = proc
            ms = self._overlay_probe((vm,), bound, removed=(a, b))
        del self._rank[vm]
        q.unmerge(undo)
        return ms

    def _overlay_probe(self, seeds, bound: float,
                       removed: tuple = ()) -> float | None:
        rank = self._rank
        heap = [(-rank.get(v, 0), v) for v in seeds]
        heapq.heapify(heap)
        queued = set(seeds)
        heappush, heappop = heapq.heappush, heapq.heappop
        q = self.q
        members, pred, succ = q.members, q.pred, q.succ
        weight, proc = q.weight, q.proc
        speeds, beta, l = self._speeds, self.beta, self.l
        top2 = self._top2_terms()
        overlay: dict[int, float] = {}
        # parent -> [(child, child term)] for children that changed —
        # lets the top2 fast path skip full child scans on fan vertices
        changed: dict[int, list[tuple[int, float]]] = {}
        while heap:
            _, v = heappop(heap)
            queued.discard(v)
            p = proc[v]
            new = weight[v] / speeds[p] if p is not None else weight[v]
            sv = succ[v]
            if sv:
                best = None
                t2e = top2.get(v)
                if t2e is not None:
                    entries = changed.get(v, ())
                    ids = {w for w, _ in entries}
                    ids.update(removed)
                    t1, c1, tb, c2 = t2e
                    if c1 not in ids:
                        static = t1
                    elif c2 is not None and c2 not in ids:
                        static = tb
                    else:
                        static = None  # both best children changed
                    if static is not None:
                        best = static
                        for _, t in entries:
                            if t > best:
                                best = t
                if best is None:
                    best = -float("inf")
                    for w, c in sv.items():
                        lw = overlay.get(w)
                        if lw is None:
                            lw = l[w]
                        cand = c / beta + lw
                        if cand > best:
                            best = cand
                new += best
            if new >= bound:
                self.last_probe_head = None  # abort: bound-independent
                return None
            if new != l.get(v):
                overlay[v] = new
                for u, c in pred[v].items():
                    if u in top2:  # only fan parents use the fast path
                        changed.setdefault(u, []).append(
                            (v, c / beta + new))
                    if u not in queued:
                        queued.add(u)
                        heappush(heap, (-rank.get(u, 0), u))
        # unchanged part: highest maintained value outside the overlay
        # (skipping entries for vertices merged away in this trial)
        ms = max(overlay.values(), default=0.0)
        head = None
        for val, v in self._values_desc():
            if v not in overlay and v in members:
                if val > ms:
                    ms = val
                    head = v
                break
        # every overlay value passed the abort check (< bound), so a
        # final "no improvement" verdict is always head-determined
        self.last_probe_head = head
        return ms if ms < bound else None

    def _values_desc(self) -> list[tuple[float, int]]:
        """``(l, v)`` pairs sorted descending; cached between mutations."""
        if self._desc_version != self._version:
            self._desc = sorted(
                ((x, v) for v, x in self.l.items()), reverse=True)
            self._desc_version = self._version
        return self._desc

    _TOP2_MIN_DEGREE = 2

    def _top2_terms(self) -> dict[int, tuple]:
        """``(t1, c1, t2, c2)`` — two best child terms of every
        high-out-degree vertex, cached between mutations.

        Lets overlay probes recompute a fan vertex in O(#changed
        children) instead of O(out-degree): the best *unchanged* term
        is ``t1`` unless the argmax child itself changed, then ``t2``,
        and only when both changed does the probe fall back to a full
        scan.  Must be (re)built before any structural trial mutates
        the graph — probe_merge primes it explicitly.
        """
        if self._top2_version != self._version:
            beta, l = self.beta, self.l
            mind = self._TOP2_MIN_DEGREE
            d = {}
            for v, sv in self.q.succ.items():
                if len(sv) >= mind:
                    t1 = t2 = -float("inf")
                    c1 = c2 = None
                    for w, c in sv.items():
                        t = c / beta + l[w]
                        if t > t1:
                            t2, c2 = t1, c1
                            t1, c1 = t, w
                        elif t > t2:
                            t2, c2 = t, w
                    d[v] = (t1, c1, t2, c2)
            self._top2 = d
            self._top2_version = self._version
        return self._top2

    def merge(self, a: int, b: int) -> tuple[int, list[int] | None]:
        """Contract ``a`` and ``b``; returns ``(vm, cycle)``.

        When ``cycle`` is not None the evaluator is *broken*: the caller
        must either resolve the cycle with another merge (Step 3's
        triple merge for 2-cycles) or ``rollback()``.  Bottom weights
        are settled only once Γ is acyclic again.

        When the ranks were exact going in, both the acyclicity check
        and the rank maintenance are *localized*: the cycle probe DFS
        is bounded by the affected rank window
        (:meth:`_cycle_after_merge`) and a Pearce–Kelly repair
        (:meth:`_pk_repair`) reorders only the affected region, so
        commits are O(region) instead of O(V + E) and exactness is
        preserved — the full :meth:`refresh_ranks` only remains for
        merges applied on top of inexact ranks (e.g. the second leg of
        a committed triple merge, whose intermediate state is cyclic).
        """
        was_exact = self._ranks_exact
        vm, undo = self.q.merge(a, b)
        if self._frames:
            self._frames[-1].ops.append(("merge", undo))
        rv = max(self._rank.get(a, 0), self._rank.get(b, 0))
        self._rank[vm] = rv
        self._ranks_exact = False
        self._pending.append((vm, a, b))
        self._version += 1
        if was_exact:
            cycle = self._cycle_after_merge(vm, rv)
        else:
            counters.bump("cycle_probe_full_dfs")
            cycle = self.q.cycle_through(vm)
        if cycle is None:
            if was_exact:
                # repair before settling: propagation then runs over
                # exact ranks and recomputes each vertex exactly once
                self._pk_repair(vm, rv)
            self._settle()
        return vm, cycle

    # -------------------------------------------------------------- #
    # localized rank maintenance (Pearce–Kelly)
    # -------------------------------------------------------------- #
    def _cycle_after_merge(self, vm: int, rv: int) -> list[int] | None:
        """A cycle through freshly merged ``vm`` (or ``None``) — the
        rank-localized version of :meth:`QuotientGraph.cycle_through`.

        Requires the *pre-merge* ranks to be exact.  Every edge not
        incident to ``vm`` then goes strictly rank-upward, so a path
        that leaves ``vm`` and returns to it must end in a predecessor
        of ``vm`` (all of which rank below ``rv = max(rank of the
        parts)``) and therefore climbs through vertices ranked below
        ``rv`` only.  The DFS explores exactly that window; on large
        quotients this is the difference between O(affected region)
        and the full-graph wander of the generic probe.  2-cycles (the
        case Step 3 resolves by triple merges) are detected first in
        O(deg), with the same ``[vm, min]`` representative the generic
        probe returns; longer cycles are returned as some explicit
        cycle (callers only branch on the length).
        """
        q = self.q
        succ = q.succ
        two = succ[vm].keys() & q.pred[vm].keys()
        if two:
            counters.bump("cycle_probe_two_cycle")
            return [vm, min(two)]
        counters.bump("cycle_probe_ranked")
        rank = self._rank
        starts = [w for w in succ[vm] if rank[w] < rv]
        if not starts:
            return None
        preds = q.pred[vm].keys()
        parent: dict[int, int] = {}
        seen = set(starts)
        stack = list(starts)
        while stack:
            u = stack.pop()
            if u in preds:  # path vm -> ... -> u -> vm closes a cycle
                cycle = [u]
                while u in parent:
                    u = parent[u]
                    cycle.append(u)
                cycle.append(vm)
                cycle.reverse()
                return cycle
            for w in succ[u]:
                if w not in seen and rank[w] < rv:
                    seen.add(w)
                    parent[w] = u
                    stack.append(w)
        return None

    def _pk_repair(self, vm: int, rv: int) -> None:
        """Pearce–Kelly localized topological reorder after a merge.

        Pre-merge ranks are exact; the merge can only violate order on
        the edges ``vm -> w`` with ``rank[w] < rv`` (parents keep
        ``rank < max(parts) = rv`` automatically).  Discovery walks
        the two affected regions — forward from the violating children
        through ranks ``< rv``, backward from ``vm`` through ranks
        ``>= lb`` (the lowest violating child) — and reassigns the
        union's own rank slots: backward region first, forward region
        after, each in its previous relative order.  All other
        vertices keep their ranks, so the repair is O(region); with no
        violations it degenerates to the O(deg) no-op check.

        Rank *values* are only ever consumed as a topological order
        (probe scheduling), never compared across runs, so swapping
        the full refresh for this repair cannot change any scheduling
        result — property-tested in ``tests/test_incremental.py``.
        """
        rank = self._rank
        q = self.q
        succ, pred = q.succ, q.pred
        viol = [w for w in succ[vm] if rank[w] < rv]
        if not viol:
            self._ranks_exact = True
            counters.bump("rank_pk_noops")
            return
        lb = min(rank[w] for w in viol)
        # forward region: violating children + their descendants < rv
        fwd = list(viol)
        seen_f = set(viol)
        stack = list(viol)
        while stack:
            u = stack.pop()
            for w in succ[u]:
                if w not in seen_f and rank[w] < rv:
                    seen_f.add(w)
                    fwd.append(w)
                    stack.append(w)
        # backward region: vm + its ancestors ranked >= lb
        back = [vm]
        seen_b = {vm}
        stack = [vm]
        while stack:
            u = stack.pop()
            for w in pred[u]:
                if w not in seen_b and rank[w] >= lb:
                    seen_b.add(w)
                    back.append(w)
                    stack.append(w)
        back.sort(key=rank.__getitem__)
        fwd.sort(key=rank.__getitem__)
        region = back + fwd
        slots = sorted(rank[x] for x in region)
        if self._frames:
            self._frames[-1].ops.append(
                ("ranks", [(x, rank[x]) for x in region]))
        for x, s in zip(region, slots):
            rank[x] = s
        self._ranks_exact = True
        counters.bump("rank_pk_repairs")
        counters.bump("rank_pk_region_vertices", len(region))

    # -------------------------------------------------------------- #
    # internals
    # -------------------------------------------------------------- #
    def _settle(self) -> None:
        """Fold pending merges into the bottom weights."""
        final = self._pending[-1][0]
        for _, a, b in self._pending:
            for x in (a, b):
                if x in self.l:
                    self._del_l(x)
        self._pending.clear()
        self._propagate((final,))

    def _del_l(self, v: int) -> None:
        if self._frames:
            self._frames[-1].lold.setdefault(v, self.l[v])
        del self.l[v]

    def _own(self, v: int) -> float:
        p = self.q.proc[v]
        s = self._speeds[p] if p is not None else 1.0
        return self.q.weight[v] / s

    def _recompute(self, v: int) -> float:
        succ = self.q.succ[v]
        own = self._own(v)
        if not succ:
            return own
        beta, l = self.beta, self.l
        return own + max(c / beta + l[w] for w, c in succ.items())

    def _propagate(self, seeds: Iterable[int]) -> None:
        """Fixed-point delta propagation through affected ancestors.

        Processes dirty vertices deepest-first (cached topological
        rank).  Ranks can go stale after merges — that only costs
        re-processing, never correctness: a vertex recomputed from a
        stale child is re-queued when the child settles.  Cutoff is
        exact float equality, which keeps the fixed point bit-identical
        to a from-scratch sweep.  (Bounded/abortable evaluation lives in
        :meth:`_overlay_probe`, which never touches the maintained
        state.)
        """
        rank = self._rank
        heap = [(-rank.get(v, 0), v) for v in seeds]
        heapq.heapify(heap)
        queued = {v for _, v in heap}
        heappush, heappop = heapq.heappush, heapq.heappop
        q = self.q
        members, pred, succ = q.members, q.pred, q.succ
        weight, proc = q.weight, q.proc
        speeds, beta, l = self._speeds, self.beta, self.l
        lheap = self._heap
        frame = self._frames[-1] if self._frames else None
        missing = _MISSING
        while heap:
            _, v = heappop(heap)
            queued.discard(v)
            if v not in members:
                continue
            p = proc[v]
            new = weight[v] / speeds[p] if p is not None else weight[v]
            sv = succ[v]
            if sv:
                best = -float("inf")
                for w, c in sv.items():
                    cand = c / beta + l[w]
                    if cand > best:
                        best = cand
                new += best
            old = l.get(v, missing)
            if new != old:
                if frame is not None:
                    frame.lold.setdefault(v, old)
                l[v] = new
                heappush(lheap, (-new, v))
                for u in pred[v]:
                    if u not in queued:
                        queued.add(u)
                        heappush(heap, (-rank.get(u, 0), u))
        self._compact_if_needed()

    def _compact_if_needed(self) -> None:
        if len(self._heap) > 64 + 4 * len(self.l):
            self._heap = [(-x, v) for v, x in self.l.items()]
            heapq.heapify(self._heap)

    # -------------------------------------------------------------- #
    # debugging / property-test hook
    # -------------------------------------------------------------- #
    def assert_consistent(self) -> None:
        """Compare every maintained value against a from-scratch sweep."""
        assert not self._pending and not self._frames
        ref = bottom_weights(self.q, self.platform)
        assert set(ref) == set(self.l), (
            f"vertex sets differ: {set(ref) ^ set(self.l)}")
        for v, x in ref.items():
            assert self.l[v] == x, (v, self.l[v], x)
