"""Typed metrics registry: counters + gauges + fixed-bucket histograms.

This generalizes the flat :mod:`repro_torch.core.counters` ``Counter`` to
three metric kinds behind one global :data:`METRICS` registry with the
same *snapshot/delta* protocol the scheduler already uses to bracket a
pipeline run:

* **counters** — monotonically increasing integers (``counter(name)``).
  :data:`METRICS.counters` *is* the ``collections.Counter`` that
  ``repro_torch.core.counters.COUNTERS`` aliases, so every existing
  ``bump()`` call site feeds this registry unchanged.
* **gauges** — last-write-wins floats (``gauge(name, value)``): queue
  depths, cache sizes, horizons.
* **histograms** — fixed-boundary bucket counts plus ``sum`` / ``count``
  / ``min`` / ``max`` (``observe(name, value)``): plan latencies, queue
  waits, makespan premia.  Quantiles (p50/p95/p99) are estimated from
  the buckets by :func:`percentile` — log-spaced default boundaries
  keep the estimate within a bucket's relative width.

Everything snapshots to plain dicts (:meth:`MetricsRegistry.snapshot`),
deltas against a snapshot (:meth:`MetricsRegistry.delta`), merges a
delta back in (:meth:`MetricsRegistry.merge`) and pickles — that is
how per-worker metrics ship back through ``SweepPoint`` under the
fork/spawn process-pool k' sweep and aggregate in the parent.

Metrics only ever *record* — they never influence control flow — so
instrumentation cannot change scheduling results (the same contract
:mod:`repro_torch.core.counters` documents).
"""
from __future__ import annotations

import math
from collections import Counter

__all__ = [
    "DEFAULT_BOUNDARIES",
    "Histogram",
    "METRICS",
    "MetricsRegistry",
    "RATIO_BOUNDARIES",
    "percentile",
    "percentiles",
]

#: log-spaced (2 buckets/decade) boundaries for duration-like values —
#: wall-clock seconds and virtual time units alike span 1e-4 .. 1e5.
DEFAULT_BOUNDARIES: tuple[float, ...] = tuple(
    round(10 ** (e / 2), 6) for e in range(-8, 11)
)

#: boundaries for ratios hovering around 1.0 (e.g. the makespan premium
#: a seeded plan pays over its cached winner).
RATIO_BOUNDARIES: tuple[float, ...] = (
    0.5, 0.9, 0.99, 1.0, 1.01, 1.02, 1.05, 1.1, 1.25, 1.5, 2.0, 4.0)


class Histogram:
    """Fixed-boundary bucket histogram (cumulative stats, not samples).

    ``boundaries`` are the *upper* bucket edges; values above the last
    edge land in an overflow bucket, so ``counts`` has
    ``len(boundaries) + 1`` entries.  The exact ``sum`` / ``count`` /
    ``min`` / ``max`` ride along, so means are exact and quantile
    estimates are clamped to the observed range.
    """

    __slots__ = ("boundaries", "counts", "sum", "count", "min", "max")

    def __init__(self, boundaries=DEFAULT_BOUNDARIES) -> None:
        self.boundaries = tuple(float(b) for b in boundaries)
        if list(self.boundaries) != sorted(set(self.boundaries)):
            raise ValueError("histogram boundaries must be strictly "
                             "increasing")
        self.counts = [0] * (len(self.boundaries) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        lo, hi = 0, len(self.boundaries)
        while lo < hi:                      # first boundary >= value
            mid = (lo + hi) // 2
            if self.boundaries[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.sum += value
        self.count += 1
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    @property
    def mean(self) -> float | None:
        """Exact mean of every observation (``None`` when empty) —
        ``sum``/``count`` ride along precisely for this."""
        return self.sum / self.count if self.count else None

    # ------------------------------------------------------------ #
    def to_dict(self) -> dict:
        """Plain-dict form (JSON- and pickle-friendly)."""
        return {
            "boundaries": list(self.boundaries),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(d["boundaries"])
        h.counts = [int(c) for c in d["counts"]]
        h.sum = float(d["sum"])
        h.count = int(d["count"])
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = -math.inf if d.get("max") is None else float(d["max"])
        return h

    def merge_dict(self, d: dict) -> None:
        """Fold a compatible histogram dict into this histogram."""
        if tuple(d["boundaries"]) != self.boundaries:
            raise ValueError("histogram boundary mismatch on merge")
        for i, c in enumerate(d["counts"]):
            self.counts[i] += int(c)
        self.sum += float(d["sum"])
        self.count += int(d["count"])
        if d.get("min") is not None:
            self.min = min(self.min, float(d["min"]))
        if d.get("max") is not None:
            self.max = max(self.max, float(d["max"]))


def _delta_hist(cur: dict, old: dict | None) -> dict | None:
    """``cur - old`` for two histogram dicts (None when nothing moved).

    min/max are not subtractable; the delta keeps the *current* values
    (exact when the snapshot was empty — the per-run bracket case)."""
    if old is None:
        return cur if cur["count"] else None
    if cur["count"] == old["count"]:
        return None
    return {
        "boundaries": list(cur["boundaries"]),
        "counts": [a - b for a, b in zip(cur["counts"], old["counts"])],
        "sum": cur["sum"] - old["sum"],
        "count": cur["count"] - old["count"],
        "min": cur["min"],
        "max": cur["max"],
    }


def percentile(hist: dict, q: float) -> float | None:
    """Estimate the ``q``-th percentile (0..100) from a histogram dict.

    Linear interpolation inside the containing bucket, clamped to the
    observed ``[min, max]`` range; ``None`` on an empty histogram.
    """
    count = hist["count"]
    if not count:
        return None
    lo_clamp = hist.get("min")
    hi_clamp = hist.get("max")
    rank = q / 100.0 * count
    cum = 0
    bounds = hist["boundaries"]
    for i, c in enumerate(hist["counts"]):
        if c == 0:
            continue
        if cum + c >= rank:
            lo = bounds[i - 1] if i > 0 else (
                lo_clamp if lo_clamp is not None else 0.0)
            hi = bounds[i] if i < len(bounds) else (
                hi_clamp if hi_clamp is not None else lo)
            frac = (rank - cum) / c
            est = lo + (hi - lo) * max(0.0, min(1.0, frac))
            if lo_clamp is not None:
                est = max(est, lo_clamp)
            if hi_clamp is not None:
                est = min(est, hi_clamp)
            return est
        cum += c
    return hi_clamp


def percentiles(hist: dict, qs=(50, 95, 99)) -> dict[str, float] | None:
    """``{"p50": ..., "p95": ..., "p99": ...}`` or ``None`` if empty."""
    if not hist or not hist.get("count"):
        return None
    return {f"p{g:g}": percentile(hist, g) for g in qs}


class MetricsRegistry:
    """The process-global home of counters, gauges and histograms."""

    def __init__(self) -> None:
        self.counters: Counter = Counter()
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    # recording -------------------------------------------------- #
    def counter(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float,
                boundaries=None) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(
                boundaries if boundaries is not None
                else DEFAULT_BOUNDARIES)
        h.observe(value)

    # snapshot / delta / merge ----------------------------------- #
    def snapshot(self) -> dict:
        """Detached copy of everything (the delta bracket's opening)."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.to_dict()
                           for k, h in self.histograms.items()},
        }

    def delta(self, snap: dict) -> dict:
        """What moved since ``snap`` — same shape as :meth:`snapshot`,
        sparse (untouched metrics are omitted).  Picklable and
        JSON-serializable: this is what crosses process boundaries."""
        counters = {
            k: v - snap["counters"].get(k, 0)
            for k, v in self.counters.items()
            if v != snap["counters"].get(k, 0)
        }
        gauges = {k: v for k, v in self.gauges.items()
                  if snap["gauges"].get(k) != v}
        hists = {}
        for k, h in self.histograms.items():
            d = _delta_hist(h.to_dict(), snap["histograms"].get(k))
            if d is not None:
                hists[k] = d
        out: dict = {}
        if counters:
            out["counters"] = counters
        if gauges:
            out["gauges"] = gauges
        if hists:
            out["histograms"] = hists
        return out

    def merge(self, delta: dict) -> None:
        """Fold a :meth:`delta` (e.g. shipped from a worker process)
        into this registry — the parent-side half of the per-worker
        metrics protocol."""
        for k, v in delta.get("counters", {}).items():
            self.counters[k] += v
        for k, v in delta.get("gauges", {}).items():
            self.gauges[k] = v
        for k, d in delta.get("histograms", {}).items():
            h = self.histograms.get(k)
            if h is None:
                self.histograms[k] = Histogram.from_dict(d)
            else:
                h.merge_dict(d)

    def restore(self, snap: dict) -> None:
        """Reset the registry to a prior :meth:`snapshot` (test
        isolation: the autouse fixture brackets every test)."""
        self.counters.clear()
        self.counters.update(snap["counters"])
        self.gauges.clear()
        self.gauges.update(snap["gauges"])
        self.histograms = {k: Histogram.from_dict(d)
                           for k, d in snap["histograms"].items()}

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()


#: the process-global registry; ``repro_torch.core.counters.COUNTERS`` is an
#: alias of ``METRICS.counters``.
METRICS = MetricsRegistry()
