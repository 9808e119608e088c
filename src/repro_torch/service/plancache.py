"""The plan cache: fingerprint → previously computed partition.

A cache entry stores the *winning partition* (``block_of_task``) and
winning k' of a completed plan, keyed on the pair (workflow digest,
platform signature) — see :mod:`repro_torch.service.fingerprint`.  A hit
replays that partition through :meth:`Scheduler.seeded
<repro_torch.core.scheduler.Scheduler.seeded>`: no k' sweep, Step 2 re-prices
the seed on the actual platform, Steps 3–4 repair and refine.  On the
same platform the seeded pipeline reproduces the cached plan's quality
(the k'-sweep winner's own refinement is a fixpoint), so the hit buys
roughly a sweep-length× planning-latency reduction at no makespan
premium; a *stale* seed (platform drifted, entry keyed elsewhere)
simply cannot occur because the platform signature is part of the key.

Eviction is LRU with a bounded capacity — the service's traffic model
is many users × few pipelines, so the working set is small and recency
is the right signal.  Hits/misses/stores are counted through
:mod:`repro_torch.core.counters` (``service_cache_hits`` /
``service_cache_misses`` / ``service_cache_stores``) and surface in
``ServiceReport.cache_stats``.  Counters never influence control flow.

The cache also persists: :meth:`PlanCache.save` writes the whole store
(keys, partitions, LRU order) as JSON and :meth:`PlanCache.load` brings
it back, so a service restart — or a benchmark's warm phase — starts
with yesterday's working set instead of a cold sweep per fingerprint.
"""
from __future__ import annotations

import hashlib
import json
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path

from repro_torch.core import counters
from repro_torch.core.platform import Platform

from .fingerprint import WorkflowFingerprint, platform_signature

__all__ = ["CachedPlan", "PlanCache"]


@dataclass
class CachedPlan:
    """One cached planning outcome (a partition, not a full mapping —
    processor assignment is always recomputed on the live platform)."""

    block_of_task: list[int]
    k_prime: int | None
    makespan: float     # as planned when stored (diagnostic only)
    hits: int = 0


class PlanCache:
    """Bounded LRU: (workflow digest, platform signature) → plan."""

    def __init__(self, capacity: int = 128) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._store: "OrderedDict[str, CachedPlan]" = OrderedDict()
        self._evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    # -------------------------------------------------------------- #
    @staticmethod
    def key(fp: WorkflowFingerprint, platform: Platform) -> str:
        h = hashlib.sha256()
        h.update(b"repro-plan-1\x00")
        h.update(fp.digest.encode("ascii"))
        h.update(platform_signature(platform).encode("ascii"))
        return h.hexdigest()

    def get(self, key: str) -> CachedPlan | None:
        """Look up ``key``; counts a hit or a miss either way."""
        plan = self._store.get(key)
        if plan is None:
            counters.bump("service_cache_misses")
            return None
        counters.bump("service_cache_hits")
        plan.hits += 1
        self._store.move_to_end(key)
        return plan

    def put(self, key: str, block_of_task: list[int],
            k_prime: int | None, makespan: float) -> None:
        self._store[key] = CachedPlan(
            block_of_task=[int(b) for b in block_of_task],
            k_prime=k_prime, makespan=float(makespan))
        self._store.move_to_end(key)
        counters.bump("service_cache_stores")
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self._evictions += 1

    def stats(self) -> dict:
        return {
            "size": len(self._store),
            "capacity": self.capacity,
            "evictions": self._evictions,
            "hits": sum(p.hits for p in self._store.values()),
        }

    # persistence --------------------------------------------------- #
    def save(self, path) -> None:
        """Write the cache to ``path`` as JSON, LRU order preserved
        (first entry = least recently used, evicted first on reload
        into a smaller cache)."""
        payload = {
            "version": 1,
            "capacity": self.capacity,
            "entries": [
                {
                    "key": key,
                    "block_of_task": list(plan.block_of_task),
                    "k_prime": plan.k_prime,
                    "makespan": plan.makespan,
                    "hits": plan.hits,
                }
                for key, plan in self._store.items()
            ],
        }
        Path(path).write_text(json.dumps(payload, indent=1))

    @classmethod
    def load(cls, path, capacity: int | None = None) -> "PlanCache":
        """Rebuild a cache from :meth:`save` output.  ``capacity``
        overrides the saved bound (excess entries evict LRU-first);
        loading counts neither hits nor stores."""
        payload = json.loads(Path(path).read_text())
        version = payload.get("version")
        if version != 1:
            raise ValueError(
                f"unsupported plan-cache file version {version!r}")
        cache = cls(capacity if capacity is not None
                    else int(payload["capacity"]))
        for e in payload["entries"]:
            cache._store[e["key"]] = CachedPlan(
                block_of_task=[int(b) for b in e["block_of_task"]],
                k_prime=(int(e["k_prime"])
                         if e["k_prime"] is not None else None),
                makespan=float(e["makespan"]),
                hits=int(e.get("hits", 0)),
            )
            while len(cache._store) > cache.capacity:
                cache._store.popitem(last=False)
                cache._evictions += 1
        return cache
