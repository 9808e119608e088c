"""Seeded arrival processes for sustained-traffic replays.

An :class:`ArrivalSpec` turns ``(rate, kind, seed)`` into the arrival
instants of N workflow instances, in the same style as
:class:`repro_torch.sim.perturb.JitterSpec`: a frozen spec whose draws are a
pure function of ``(seed, stream)`` through the shared
:func:`repro_torch.sim.rng.stream_rng` helper — identical seeds give
identical traces across subsystems, processes and platforms.

Kinds:

* ``poisson`` — exponential inter-arrival gaps of mean ``1/rate`` (the
  classic open-loop traffic model; bursts stress the pipelined
  schedule beyond its steady-state period);
* ``deterministic`` — exact spacing ``1/rate`` (the periodic regime the
  steady-state analysis in :mod:`repro_torch.throughput.replicate` prices).

``rate`` is in instances per virtual time unit, the same clock the
simulation engine runs on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.sim.rng import stream_rng

__all__ = ["ArrivalSpec"]

# SeedSequence namespace for arrival draws (jitter uses 0x51D0)
_ARRIVAL_TAG = 0xA221

_KINDS = ("poisson", "deterministic")


@dataclass(frozen=True)
class ArrivalSpec:
    """How instances arrive: ``kind`` ∈ {poisson, deterministic}."""

    rate: float
    kind: str = "poisson"
    start: float = 0.0

    def __post_init__(self) -> None:
        if not self.rate > 0:
            raise ValueError(f"arrival rate must be > 0, got {self.rate}")
        if self.kind not in _KINDS:
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.start < 0:
            raise ValueError("arrival start must be >= 0")

    def times(self, n: int, seed: int = 0, stream: int = 0) -> np.ndarray:
        """Arrival instants of instances ``0..n-1`` (non-decreasing).

        ``deterministic`` arrivals begin *at* ``start`` (instance 0
        arrives exactly then — the rate→0 limit reproduces a solo
        run released at ``start``); ``poisson`` arrivals begin one
        exponential gap after it, as a Poisson process does.
        """
        if n < 1:
            raise ValueError(f"need at least one instance, got {n}")
        if self.kind == "deterministic":
            return self.start + np.arange(n, dtype=np.float64) / self.rate
        rng = stream_rng(_ARRIVAL_TAG, seed, stream)
        gaps = rng.exponential(1.0 / self.rate, size=n)
        return self.start + np.cumsum(gaps)
