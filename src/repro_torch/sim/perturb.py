"""Seeded stochastic perturbation of block durations.

Real task runtimes jitter around their nominal work/speed estimate;
replaying a plan under N seeded perturbations yields a robustness
envelope for its makespan (``SimReport.envelope``).  Factors are drawn
per *block* (the engine's schedulable unit) and multiply its nominal
duration; the same ``(seed, replica)`` pair always reproduces the same
factors regardless of call order, process, or platform — the
determinism contract the scheduler's parallel paths rely on.

Kinds:

* ``lognormal`` — ``exp(N(-amount^2/2, amount))``: mean-1 multiplicative
  noise, the classic heavy-tailed runtime model (``amount`` = sigma of
  the underlying normal);
* ``uniform`` — ``U(max(0, 1-amount), 1+amount)``: bounded symmetric
  jitter.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .rng import stream_rng

__all__ = ["JitterSpec"]

# namespaces the SeedSequence so sim draws never collide with other
# consumers of the same user-facing seed (e.g. the arrival processes
# of the throughput analysis, which use their own tag through the same
# stream_rng helper)
_STREAM_TAG = 0x51D0


@dataclass(frozen=True)
class JitterSpec:
    """How to perturb durations: ``kind`` ∈ {lognormal, uniform}."""

    amount: float
    kind: str = "lognormal"

    def __post_init__(self) -> None:
        if self.amount < 0:
            raise ValueError("jitter amount must be >= 0")
        if self.kind not in ("lognormal", "uniform"):
            raise ValueError(f"unknown jitter kind {self.kind!r}")

    def factors(self, n: int, seed: int, replica: int) -> np.ndarray:
        """``n`` multiplicative duration factors for one replica."""
        rng = stream_rng(_STREAM_TAG, seed, replica)
        a = self.amount
        if a == 0.0:
            return np.ones(n)
        if self.kind == "lognormal":
            return np.exp(rng.normal(-0.5 * a * a, a, size=n))
        return rng.uniform(max(0.0, 1.0 - a), 1.0 + a, size=n)
