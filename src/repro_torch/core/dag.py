"""Workflow DAG model (paper §3.1).

A workflow is a directed acyclic graph ``G = (V, E)``:

* each task ``u`` performs ``w[u]`` operations (makespan weight),
* each task needs ``m[u]`` memory for its own execution,
* each edge ``(u, v)`` carries ``c[u, v]`` bytes — the (logical) output file
  written by ``u`` and read by ``v``.

The task memory *requirement* (paper Eq. before §3.2)::

    r_u = sum_in c[v,u] + sum_out c[u,v] + m[u]

This module deliberately avoids heavyweight graph libraries in the hot
paths: adjacency is stored as ``list[dict[int, float]]`` which is fast
enough for the paper's largest instances (30 000 tasks) while staying
mutable and simple.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

import numpy as np

__all__ = [
    "Workflow",
    "QuotientGraph",
    "FlatQuotient",
    "build_quotient",
]


class Workflow:
    """A weighted DAG workflow.

    Attributes:
      work: per-task makespan weights ``w_u`` (operations).
      mem:  per-task memory weights ``m_u``.
      succ: ``succ[u][v] = c[u, v]`` for each edge ``(u, v)``.
      pred: ``pred[v][u] = c[u, v]`` (reverse adjacency).
      name: optional label (workflow family, arch id, ...).
    """

    def __init__(self, n: int = 0, name: str = "workflow") -> None:
        self.name = name
        self._n_edges = 0
        # Monotone mutation counter: bumped by every add_task/add_edge
        # so per-instance caches (the partitioner's locality-order
        # cache) can detect *any* edit, including same-shape ones —
        # accumulating cost onto an existing edge moves neither n nor
        # n_edges, which a (n, n_edges) guard alone cannot see.
        self._version = 0
        self.work: list[float] = [0.0] * n
        self.mem: list[float] = [0.0] * n
        # Persistent residency (bytes held for the whole execution —
        # e.g. model weights / KV caches in the placement layer).  The
        # paper's model has only transient task memory; persistent == 0
        # reproduces it exactly.  block requirement = Σ persistent +
        # transient traversal peak (see memdag.block_requirement).
        self.persistent: list[float] = [0.0] * n
        self.succ: list[dict[int, float]] = [dict() for _ in range(n)]
        self.pred: list[dict[int, float]] = [dict() for _ in range(n)]
        self.labels: list[str] = [f"t{i}" for i in range(n)]

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def add_task(self, work: float = 1.0, mem: float = 1.0,
                 label: str | None = None,
                 persistent: float = 0.0) -> int:
        u = len(self.work)
        self._version += 1
        self.work.append(float(work))
        self.mem.append(float(mem))
        self.persistent.append(float(persistent))
        self.succ.append(dict())
        self.pred.append(dict())
        self.labels.append(label if label is not None else f"t{u}")
        return u

    def add_edge(self, u: int, v: int, cost: float = 1.0) -> None:
        if u == v:
            raise ValueError(f"self loop on task {u}")
        self._version += 1
        if v not in self.succ[u]:
            self._n_edges += 1
        elif getattr(self, "_flat_cache", None) is not None:
            # accumulating onto an existing edge changes costs without
            # moving (n, n_edges) — the flat CSR view's validity guard
            # cannot see it, so drop the view explicitly
            self._flat_cache = None
        self.succ[u][v] = self.succ[u].get(v, 0.0) + float(cost)
        self.pred[v][u] = self.pred[v].get(u, 0.0) + float(cost)

    # ------------------------------------------------------------------ #
    # basic queries
    # ------------------------------------------------------------------ #
    @property
    def n(self) -> int:
        return len(self.work)

    @property
    def n_edges(self) -> int:
        """Distinct edge count, maintained by :meth:`add_edge` (O(1)).

        Hot path: the flat-array Step-2 view and the partitioner's
        locality-order cache guard their validity on ``(n, n_edges)``
        per call, so this must not rescan the adjacency.
        """
        return self._n_edges

    def parents(self, u: int) -> Iterable[int]:
        return self.pred[u].keys()

    def children(self, u: int) -> Iterable[int]:
        return self.succ[u].keys()

    def sources(self) -> list[int]:
        return [u for u in range(self.n) if not self.pred[u]]

    def targets(self) -> list[int]:
        return [u for u in range(self.n) if not self.succ[u]]

    def in_cost(self, u: int) -> float:
        return sum(self.pred[u].values())

    def out_cost(self, u: int) -> float:
        return sum(self.succ[u].values())

    def task_requirement(self, u: int) -> float:
        """``r_u`` — input files + output files + task memory."""
        return self.in_cost(u) + self.out_cost(u) + self.mem[u]

    def total_work(self) -> float:
        return float(sum(self.work))

    # ------------------------------------------------------------------ #
    # orders / validity
    # ------------------------------------------------------------------ #
    def topological_order(
        self, priority: Callable[[int], float] | None = None
    ) -> list[int]:
        """Kahn's algorithm; ready tasks popped by ``priority`` (min-heap).

        Raises ``ValueError`` when the graph has a cycle.
        """
        indeg = [len(self.pred[u]) for u in range(self.n)]
        if priority is None:
            prio = lambda u: u  # deterministic FIFO-ish
        else:
            prio = priority
        heap = [(prio(u), u) for u in range(self.n) if indeg[u] == 0]
        heapq.heapify(heap)
        order: list[int] = []
        while heap:
            _, u = heapq.heappop(heap)
            order.append(u)
            for v in self.succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    heapq.heappush(heap, (prio(v), v))
        if len(order) != self.n:
            raise ValueError("workflow graph contains a cycle")
        return order

    def is_dag(self) -> bool:
        try:
            self.topological_order()
            return True
        except ValueError:
            return False

    # ------------------------------------------------------------------ #
    # sub-workflows
    # ------------------------------------------------------------------ #
    def subgraph(self, nodes: Sequence[int]) -> tuple["Workflow", list[int]]:
        """Induced sub-workflow over ``nodes``.

        Returns ``(sub, mapping)`` where ``mapping[i]`` is the original id
        of sub-task ``i``.  Edges crossing the boundary are *not* part of
        the sub-workflow; callers that need them (peak-memory computation)
        use :meth:`boundary_costs`.
        """
        mapping = list(nodes)
        inv = {u: i for i, u in enumerate(mapping)}
        sub = Workflow(len(mapping), name=f"{self.name}-sub")
        for i, u in enumerate(mapping):
            sub.work[i] = self.work[u]
            sub.mem[i] = self.mem[u]
            sub.persistent[i] = self.persistent[u]
            sub.labels[i] = self.labels[u]
            for v, c in self.succ[u].items():
                j = inv.get(v)
                if j is not None:
                    sub.add_edge(i, j, c)
        return sub, mapping

    def boundary_costs(
        self, nodes: Sequence[int]
    ) -> tuple[dict[int, float], dict[int, float]]:
        """External input / output volume per member of ``nodes``.

        Returns ``(ext_in, ext_out)`` keyed by *local* index in ``nodes``:
        the summed weight of edges arriving from outside the set and
        leaving towards outside the set.
        """
        members = set(nodes)
        ext_in: dict[int, float] = {}
        ext_out: dict[int, float] = {}
        for i, u in enumerate(nodes):
            cin = sum(c for v, c in self.pred[u].items() if v not in members)
            cout = sum(c for v, c in self.succ[u].items() if v not in members)
            if cin:
                ext_in[i] = cin
            if cout:
                ext_out[i] = cout
        return ext_in, ext_out


# ---------------------------------------------------------------------- #
# quotient graph (paper §3.3)
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class FlatQuotient:
    """Flat CSR snapshot of a :class:`QuotientGraph`'s adjacency.

    Vertices appear in topological order; ``vids[i]`` is the quotient
    vertex id at position ``i`` and ``pos`` maps back.  ``indptr`` /
    ``indices`` / ``costs`` describe successor adjacency in CSR form
    (``indices`` holds *positions*, not vids), so bottom-weight sweeps
    can run array-driven instead of dict-driven.
    """

    vids: np.ndarray      # int64 [n]   vertex ids in topological order
    pos: dict             # vid -> position
    indptr: np.ndarray    # int64 [n+1] successor row pointers
    indices: np.ndarray   # int64 [nnz] successor positions
    costs: np.ndarray     # float64 [nnz] edge costs
    weight: np.ndarray    # float64 [n]  block work

    @property
    def n(self) -> int:
        return len(self.vids)


@dataclass
class QuotientGraph:
    """Mutable quotient DAG ``Γ`` induced by a partition of a workflow.

    Vertices are blocks of the original DAG.  Supports the merge /
    unmerge operations needed by the paper's Step 3 (Algorithm 3/4) and
    the swaps of Step 4.  ``proc[v]`` is the processor index a block is
    assigned to, or ``None``.
    """

    wf: Workflow
    members: dict[int, set[int]] = field(default_factory=dict)  # vid -> tasks
    weight: dict[int, float] = field(default_factory=dict)      # Σ w_u
    succ: dict[int, dict[int, float]] = field(default_factory=dict)
    pred: dict[int, dict[int, float]] = field(default_factory=dict)
    proc: dict[int, int | None] = field(default_factory=dict)
    _next_vid: int = 0

    # -------------------------------------------------------------- #
    def vertices(self) -> list[int]:
        return list(self.members.keys())

    @property
    def n_vertices(self) -> int:
        return len(self.members)

    def new_vertex(self, tasks: set[int]) -> int:
        vid = self._next_vid
        self._next_vid += 1
        self.members[vid] = set(tasks)
        self.weight[vid] = float(sum(self.wf.work[u] for u in tasks))
        self.succ[vid] = {}
        self.pred[vid] = {}
        self.proc[vid] = None
        return vid

    def add_edge(self, a: int, b: int, cost: float) -> None:
        if a == b:
            return
        self.succ[a][b] = self.succ[a].get(b, 0.0) + cost
        self.pred[b][a] = self.pred[b].get(a, 0.0) + cost

    # -------------------------------------------------------------- #
    def is_acyclic(self) -> bool:
        return self.find_cycle() is None

    def find_cycle(self) -> list[int] | None:
        """Return some cycle (list of vertices) or ``None``.

        Uses Kahn peeling: whatever cannot be peeled belongs to a cycle;
        we then walk successor links within the residual to extract one
        explicit cycle (the paper's Step 3 needs its *length*).
        """
        indeg = {v: len(self.pred[v]) for v in self.members}
        stack = [v for v, d in indeg.items() if d == 0]
        seen = 0
        while stack:
            v = stack.pop()
            seen += 1
            for w in self.succ[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        if seen == len(self.members):
            return None
        residual = {v for v, d in indeg.items() if d > 0}
        # Every residual vertex kept an unprocessed predecessor, which is
        # itself residual — so walking predecessor links must loop.
        start = next(iter(residual))
        path: list[int] = []
        pos: dict[int, int] = {}
        v = start
        while v not in pos:
            pos[v] = len(path)
            path.append(v)
            v = next(w for w in self.pred[v] if w in residual)
        return path[pos[v]:]

    def topological_order(self) -> list[int]:
        indeg = {v: len(self.pred[v]) for v in self.members}
        heap = [v for v, d in indeg.items() if d == 0]
        heapq.heapify(heap)
        order = []
        while heap:
            v = heapq.heappop(heap)
            order.append(v)
            for w in self.succ[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    heapq.heappush(heap, w)
        if len(order) != len(self.members):
            raise ValueError("quotient graph is cyclic")
        return order

    def topological_order_fast(self) -> list[int]:
        """Stack-based Kahn: any valid order, no id-ordering guarantee.

        Used where only *a* topological order matters (rank refreshes
        in the incremental evaluator) — the heap in
        :meth:`topological_order` buys deterministic id-sorted layers
        that rank maintenance does not need.
        """
        indeg = {v: len(self.pred[v]) for v in self.members}
        stack = [v for v, d in indeg.items() if d == 0]
        order: list[int] = []
        while stack:
            v = stack.pop()
            order.append(v)
            for w in self.succ[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        if len(order) != len(self.members):
            raise ValueError("quotient graph is cyclic")
        return order

    # -------------------------------------------------------------- #
    # merge / unmerge (Step 3 machinery)
    # -------------------------------------------------------------- #
    def merge(self, a: int, b: int) -> tuple[int, dict]:
        """Merge vertices ``a`` and ``b`` into a new vertex.

        Returns ``(vm, undo)`` where ``undo`` restores the previous state
        via :meth:`unmerge`.  The merged vertex inherits *no* processor
        assignment; callers set it explicitly.

        The undo record is O(deg(a) + deg(b)): the dicts of ``a`` and
        ``b`` are kept *by reference* (merge never mutates them — it
        only unlinks them from the graph), and for each touched
        neighbour we remember exactly which key was cut instead of
        snapshotting its whole adjacency.  Unmerges must be LIFO with
        respect to merges (nested merge trials unwind in reverse).
        """
        undo = {
            "a": a,
            "b": b,
            "a_state": (self.members[a], self.weight[a],
                        self.succ[a], self.pred[a], self.proc[a]),
            "b_state": (self.members[b], self.weight[b],
                        self.succ[b], self.pred[b], self.proc[b]),
            "cut_pred": [],   # (w, old, c): edge old->w removed from pred[w]
            "cut_succ": [],   # (w, old, c): edge w->old removed from succ[w]
        }
        tasks = self.members[a] | self.members[b]
        vm = self.new_vertex(tasks)
        undo["vm"] = vm
        for old in (a, b):
            for w, c in self.succ[old].items():
                if w in (a, b):
                    continue
                undo["cut_pred"].append((w, old, c))
                del self.pred[w][old]
                self.add_edge(vm, w, c)
            for w, c in self.pred[old].items():
                if w in (a, b):
                    continue
                undo["cut_succ"].append((w, old, c))
                del self.succ[w][old]
                self.add_edge(w, vm, c)
        for old in (a, b):
            del self.members[old], self.weight[old]
            del self.succ[old], self.pred[old], self.proc[old]
        return vm, undo

    def unmerge(self, undo: dict) -> None:
        vm = undo["vm"]
        del self.members[vm], self.weight[vm]
        del self.succ[vm], self.pred[vm], self.proc[vm]
        for w, old, c in undo["cut_pred"]:
            self.pred[w].pop(vm, None)
            self.pred[w][old] = c
        for w, old, c in undo["cut_succ"]:
            self.succ[w].pop(vm, None)
            self.succ[w][old] = c
        for v, st in ((undo["a"], undo["a_state"]),
                      (undo["b"], undo["b_state"])):
            members, weight, succ, pred, proc = st
            self.members[v] = members
            self.weight[v] = weight
            self.succ[v] = succ
            self.pred[v] = pred
            self.proc[v] = proc

    def cycle_through(self, v: int) -> list[int] | None:
        """A cycle through ``v`` (or ``None``) — localized cycle probe.

        After ``merge(a, b) -> vm`` on a previously acyclic graph, every
        new cycle passes through ``vm`` (merge only rewires edges
        incident to the merged vertex), so this is a complete acyclicity
        check for the merge result.  2-cycles — the case Step 3 resolves
        by triple merges — are detected first in O(deg(v)).
        """
        two = self.succ[v].keys() & self.pred[v].keys()
        if two:
            return [v, min(two)]
        # iterative DFS from v's successors looking for v
        parent: dict[int, int] = {}
        stack = [(v, iter(self.succ[v]))]
        seen = {v}
        while stack:
            u, it = stack[-1]
            for w in it:
                if w == v:
                    cycle = [v]
                    while u != v:
                        cycle.append(u)
                        u = parent[u]
                    cycle.reverse()
                    return cycle
                if w not in seen:
                    seen.add(w)
                    parent[w] = u
                    stack.append((w, iter(self.succ[w])))
                    break
            else:
                stack.pop()
        return None

    # -------------------------------------------------------------- #
    def csr_arrays(self, order: Sequence[int] | None = None) -> FlatQuotient:
        """Flat CSR snapshot of the current adjacency (see FlatQuotient).

        ``order`` may supply a precomputed topological order to avoid
        recomputing it.  The snapshot is immutable and detached: later
        mutations of the quotient graph do not update it.
        """
        vid_list = list(order) if order is not None else \
            self.topological_order()
        n = len(vid_list)
        pos = {v: i for i, v in enumerate(vid_list)}
        indptr = np.zeros(n + 1, dtype=np.int64)
        for i, v in enumerate(vid_list):
            indptr[i + 1] = indptr[i] + len(self.succ[v])
        nnz = int(indptr[-1])
        indices = np.empty(nnz, dtype=np.int64)
        costs = np.empty(nnz, dtype=np.float64)
        k = 0
        for v in vid_list:
            for w, c in self.succ[v].items():
                indices[k] = pos[w]
                costs[k] = c
                k += 1
        weight = np.fromiter((self.weight[v] for v in vid_list),
                             dtype=np.float64, count=n)
        return FlatQuotient(
            vids=np.asarray(vid_list, dtype=np.int64),
            pos=pos, indptr=indptr, indices=indices, costs=costs,
            weight=weight,
        )

    def assignment_array(self) -> np.ndarray:
        """Per-task block id (−1 where unassigned to any block)."""
        arr = np.full(self.wf.n, -1, dtype=np.int64)
        for vid, tasks in self.members.items():
            for u in tasks:
                arr[u] = vid
        return arr


def build_quotient(wf: Workflow, block_of: Sequence[int]) -> QuotientGraph:
    """Build the quotient graph Γ for partition function ``block_of``.

    ``block_of[u]`` is an arbitrary hashable block id per task.  Tasks
    mapped to the same id become one quotient vertex.
    """
    q = QuotientGraph(wf)
    groups: dict[object, set[int]] = {}
    for u, b in enumerate(block_of):
        groups.setdefault(b, set()).add(u)
    vid_of: dict[object, int] = {}
    # Deterministic vertex numbering: sort groups by smallest member.
    for b in sorted(groups, key=lambda b: min(groups[b])):
        vid_of[b] = q.new_vertex(groups[b])
    for u in range(wf.n):
        bu = vid_of[block_of[u]]
        for v, c in wf.succ[u].items():
            bv = vid_of[block_of[v]]
            if bu != bv:
                q.add_edge(bu, bv, c)
    return q
