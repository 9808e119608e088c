"""Makespan computation via bottom weights (paper §3.3, Eqs. (1)–(2)).

Bottom weight of a quotient vertex ν::

    l_ν = w_ν / s_ν                                    if C_ν = ∅
    l_ν = w_ν / s_ν + max_{ν'∈C_ν} ( c_{ν,ν'} / β + l_ν' )   otherwise

where ``s_ν`` is the speed of the processor assigned to ν (1 when the
vertex is still unassigned — the *estimated makespan* regime), and β the
platform bandwidth.  The makespan of Γ is the maximum bottom weight.

The critical path is the chain realizing that maximum; Step 3 of the
heuristic avoids merging into it and Step 4's idle moves walk it.
"""
from __future__ import annotations

import numpy as np

from .dag import FlatQuotient, QuotientGraph
from .platform import Platform

__all__ = [
    "bottom_weights",
    "bottom_weights_flat",
    "makespan",
    "critical_path",
]


def _speed(q: QuotientGraph, platform: Platform, v: int) -> float:
    p = q.proc[v]
    return platform.procs[p].speed if p is not None else 1.0


def bottom_weights(q: QuotientGraph, platform: Platform) -> dict[int, float]:
    """Bottom weight per quotient vertex (Eq. (1)). Γ must be acyclic."""
    order = q.topological_order()
    beta = platform.bandwidth
    l: dict[int, float] = {}
    for v in reversed(order):
        own = q.weight[v] / _speed(q, platform, v)
        if not q.succ[v]:
            l[v] = own
        else:
            l[v] = own + max(
                c / beta + l[w] for w, c in q.succ[v].items()
            )
    return l


def bottom_weights_flat(
    q: QuotientGraph,
    platform: Platform,
    flat: FlatQuotient | None = None,
) -> np.ndarray:
    """Array-driven bottom-weight sweep over a CSR snapshot.

    Returns ``l`` indexed by *position* in ``flat`` (``flat.vids[i]`` is
    the vertex at position ``i``).  Produces bit-identical values to
    :func:`bottom_weights` — ``max`` over floats is order-independent
    and the per-term arithmetic (``c / beta + l_child``) matches.  Used
    by the incremental evaluator for its full (re)builds; the dict
    version stays as the mutation-friendly reference.
    """
    if flat is None:
        flat = q.csr_arrays()
    n = flat.n
    beta = platform.bandwidth
    l = np.empty(n, dtype=np.float64)
    own = np.empty(n, dtype=np.float64)
    for i in range(n):
        own[i] = flat.weight[i] / _speed(q, platform, int(flat.vids[i]))
    indptr, indices, costs = flat.indptr, flat.indices, flat.costs
    for i in range(n - 1, -1, -1):
        s, e = indptr[i], indptr[i + 1]
        if s == e:
            l[i] = own[i]
        elif e - s < 16:
            best = -np.inf
            for k in range(s, e):
                cand = costs[k] / beta + l[indices[k]]
                if cand > best:
                    best = cand
            l[i] = own[i] + best
        else:
            l[i] = own[i] + float(np.max(costs[s:e] / beta + l[indices[s:e]]))
    return l


def makespan(q: QuotientGraph, platform: Platform) -> float:
    """Makespan of Γ (Eq. (2)) — max bottom weight over vertices."""
    if not q.members:
        return 0.0
    return max(bottom_weights(q, platform).values())


def critical_path(q: QuotientGraph, platform: Platform) -> list[int]:
    """The chain of quotient vertices realizing the makespan."""
    if not q.members:
        return []
    l = bottom_weights(q, platform)
    beta = platform.bandwidth
    v = max(l, key=lambda x: l[x])
    path = [v]
    while q.succ[v]:
        # child attaining the max in Eq. (1)
        v = max(q.succ[v], key=lambda w: q.succ[v][w] / beta + l[w])
        path.append(v)
    return path
