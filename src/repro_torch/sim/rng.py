"""Shared seeded-RNG construction for every stochastic subsystem.

All stochastic draws in the codebase — duration jitter
(:mod:`repro_torch.sim.perturb`), arrival processes
(:mod:`repro_torch.throughput.arrivals`), future failure-trace generators —
go through :func:`stream_rng` so the determinism contract is uniform:
the same ``(tag, seed, stream)`` triple always reproduces the same
draws regardless of call order, process, or platform.  ``tag``
namespaces the :class:`numpy.random.SeedSequence` per subsystem, so two
consumers of the *same user-facing seed* never collide; ``stream``
separates independent replicas/streams under one seed (jitter replicas,
tenant arrival streams).
"""
from __future__ import annotations

import numpy as np

__all__ = ["stream_rng"]


def stream_rng(tag: int, seed: int, stream: int = 0) -> np.random.Generator:
    """A PCG64 generator seeded on the ``(tag, seed, stream)`` triple.

    Exactly ``np.random.default_rng([tag, seed, stream])`` — kept in
    one place so every subsystem's seeding is bit-compatible with the
    jitter contract (`JitterSpec.factors` draws from
    ``default_rng([_STREAM_TAG, seed, replica])``; this helper
    generalizes it without changing a single draw).
    """
    return np.random.default_rng([int(tag), int(seed), int(stream)])
