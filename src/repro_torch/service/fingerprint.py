"""DAG fingerprints and platform signatures for the plan cache.

A :class:`WorkflowFingerprint` is a canonical content digest of a
workflow: a SHA-256 over a fixed byte encoding of the task count, every
task's exact weights (work / memory / persistent, as little-endian
IEEE-754 doubles) and every edge with its exact cost, in task-id order.
Two workflows collide only if they are the same instance bit for bit —
same shape *and* same weights — so a cache hit can never seed from a
look-alike DAG with different numbers (the "no false hits" property
test in ``tests/test_service.py``).  The digest depends only on
workflow *content*, never on process state, object identity or hash
randomization, so it is stable across process restarts — a persisted
plan cache stays valid.

Task numbering is part of the identity: the same pipeline submitted
with permuted task ids fingerprints differently.  That trades a few
false *misses* (harmless: the job just plans cold) for a digest that is
O(V + E) with no canonical-labeling search — the millions-of-users case
is many submissions of the *same generated instance*, which reuses ids.

The coarse ``work_hist`` / ``mem_hist`` log-histograms ride along for
observability (which traffic classes hit the cache) and as a cheap
pre-filter for future approximate matching; they do **not** loosen the
key — the digest alone decides equality.

:func:`platform_signature` plays the same role for the platform side of
a cache key: processor (speed, memory) pairs in index order, the
uniform bandwidth, and any per-link overrides.  Platform *names* are
deliberately excluded — ``Platform.without`` renames carved
sub-platforms (``"…-degraded"``), and a plan is reusable wherever the
same processors are free, whatever the carve is called.
"""
from __future__ import annotations

import hashlib
import math
import struct
from dataclasses import dataclass

from repro_torch.core.dag import Workflow
from repro_torch.core.platform import Platform

__all__ = [
    "WorkflowFingerprint",
    "fingerprint_workflow",
    "platform_signature",
]

_HEADER = b"repro-fp-1\x00"
_HIST_BINS = 8
_HIST_LO = -3.0   # log10 bucket range: 1e-3 .. 1e9
_HIST_HI = 9.0


def _f8(x: float) -> bytes:
    return struct.pack("<d", float(x))


def _i8(x: int) -> bytes:
    return struct.pack("<q", int(x))


def _log_hist(values) -> tuple[int, ...]:
    hist = [0] * _HIST_BINS
    for x in values:
        if x <= 0:
            b = 0
        else:
            t = (math.log10(x) - _HIST_LO) / (_HIST_HI - _HIST_LO)
            b = min(_HIST_BINS - 1, max(0, int(t * _HIST_BINS)))
        hist[b] += 1
    return tuple(hist)


@dataclass(frozen=True)
class WorkflowFingerprint:
    """Canonical identity of a workflow: exact digest + coarse shape."""

    digest: str                 # SHA-256 hex over the canonical encoding
    n: int
    n_edges: int
    work_hist: tuple[int, ...]  # log10-bucketed work weights
    mem_hist: tuple[int, ...]   # log10-bucketed memory weights

    def to_dict(self) -> dict:
        return {
            "digest": self.digest,
            "n": self.n,
            "n_edges": self.n_edges,
            "work_hist": list(self.work_hist),
            "mem_hist": list(self.mem_hist),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkflowFingerprint":
        return cls(
            digest=d["digest"], n=int(d["n"]),
            n_edges=int(d["n_edges"]),
            work_hist=tuple(int(x) for x in d["work_hist"]),
            mem_hist=tuple(int(x) for x in d["mem_hist"]),
        )


def fingerprint_workflow(wf: Workflow) -> WorkflowFingerprint:
    """Digest ``wf``'s exact content; see the module docstring."""
    h = hashlib.sha256()
    h.update(_HEADER)
    h.update(_i8(wf.n))
    h.update(_i8(wf.n_edges))
    for u in range(wf.n):
        h.update(_f8(wf.work[u]))
        h.update(_f8(wf.mem[u]))
        h.update(_f8(wf.persistent[u]))
    for u in range(wf.n):
        for v in sorted(wf.succ[u]):
            h.update(_i8(u))
            h.update(_i8(v))
            h.update(_f8(wf.succ[u][v]))
    return WorkflowFingerprint(
        digest=h.hexdigest(),
        n=wf.n,
        n_edges=wf.n_edges,
        work_hist=_log_hist(wf.work),
        mem_hist=_log_hist(wf.mem),
    )


def platform_signature(platform: Platform) -> str:
    """Digest of everything about ``platform`` that planning sees:
    (speed, memory) per processor in index order, the uniform β, and
    per-link overrides.  Name-independent (see module docstring)."""
    h = hashlib.sha256()
    h.update(b"repro-plat-1\x00")
    h.update(_i8(platform.k))
    h.update(_f8(platform.bandwidth))
    for p in platform.procs:
        h.update(_f8(p.speed))
        h.update(_f8(p.memory))
    for (a, b), bw in sorted(platform.link_bandwidth.items()):
        h.update(_i8(a))
        h.update(_i8(b))
        h.update(_f8(bw))
    return h.hexdigest()
