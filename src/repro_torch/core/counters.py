"""Lightweight global perf counters for the scheduling hot paths.

The scheduler's pipeline stages are instrumented with named counters —
Step-1 partitioner dispatch and refinement work (``step1_scalar_calls``
/ ``step1_flat_calls`` / ``step1_multilevel_calls``, ``step1_moves``,
``step1_passes``, ``step1_coarsen_levels``, ``step1_cut_before`` /
``step1_cut_after``), Step-2 flat-vs-scalar dispatch and
requirement-memo reuse, the incremental evaluator's Pearce–Kelly rank
repairs vs full refreshes, Step-4 swap-probe cache hits — so every
:class:`SweepPoint` can carry
the *cache statistics* of its pipeline run (``cache_stats``) next to
its stage timings.  :func:`snapshot` / :func:`delta` bracket one
pipeline execution; under the parallel k' sweep each worker process
accumulates its own counters and ships the per-point delta back inside
the (picklable) ``SweepPoint``.  The service layer
(:mod:`repro_torch.service`) counts through the same registry — job
lifecycle (``service_admissions`` / ``service_dispatches`` /
``service_completions`` / ``service_rejections`` /
``service_infeasible``), contention (``service_deferrals`` /
``service_displacements``), event handling (``service_replans`` /
``service_replan_cold_fallbacks``) and plan-cache traffic
(``service_cache_hits`` / ``service_cache_misses`` /
``service_cache_stores`` / ``service_seed_fallbacks``) — surfaced as
``ServiceReport.cache_stats``.

Counters only ever *count* — they never influence control flow — so
instrumentation cannot change scheduling results.

This module is the **counter facet** of the typed metrics
registry (:data:`repro_torch.obs.metrics.METRICS`): :data:`COUNTERS` *is*
``METRICS.counters``, so every ``bump()`` feeds the registry that also
holds gauges and histograms, and the registry's snapshot/delta/merge
protocol subsumes this module's; the narrow API below stays for the
call sites that only count.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.obs.metrics import METRICS

__all__ = ["COUNTERS", "bump", "snapshot", "delta", "reset"]

COUNTERS: Counter = METRICS.counters


def bump(name: str, n: int = 1) -> None:
    """Increment counter ``name`` by ``n``."""
    COUNTERS[name] += n


def snapshot() -> dict[str, int]:
    """Current counter values (a detached copy)."""
    return dict(COUNTERS)


def delta(snap: dict[str, int]) -> dict[str, int]:
    """Counters that moved since ``snap`` (name -> increment)."""
    return {
        k: v - snap.get(k, 0)
        for k, v in COUNTERS.items()
        if v != snap.get(k, 0)
    }


def reset() -> None:
    """Zero all counters (test isolation)."""
    COUNTERS.clear()
