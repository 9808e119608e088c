"""Heterogeneous execution environments (the paper's §3.2 and §5.1.2),
the port's copy of ``repro/core/platform.py``.

A platform is a set of processors, each with its own memory size ``M_j``
and speed ``s_j``, plus a uniform interconnect bandwidth ``β``.  Directed
links may override ``β`` (:meth:`Platform.with_link_bandwidth`); the
analytic makespan keeps the uniform value (the paper's model).  Failure
rates and power models are optional, sparse maps by processor index.
Every elastic transform carries all three: :meth:`Platform.with_speed`,
:meth:`Platform.with_processors`, :meth:`Platform.with_bandwidth` and
:meth:`Platform.with_link_bandwidth` keep them, :meth:`Platform.without`
reindexes the surviving entries.

Ships the paper's experimental clusters (Tables 2–3: GHz and GB, the
paper's processors) and the port's fleet presets :func:`h100_fleet` /
:func:`h100_fleet_si`, where a processor is one NVIDIA H100 SXM5 80 GB.
Their rates and bytes are the data sheet's (``kernels/cost.py``, the
port's one copy of them): spec values, not measurements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

from repro_torch.kernels import cost

__all__ = ["Processor", "ProcPower", "Platform", "default_cluster", "small_cluster",
           "large_cluster", "more_het_cluster", "less_het_cluster", "no_het_cluster",
           "H100_KINDS", "h100_fleet", "h100_fleet_si"]


@dataclass(frozen=True)
class Processor:
    name: str
    speed: float   # normalized ops/s (paper: GHz); H100 preset: TFLOP/s (SI preset: FLOP/s)
    memory: float  # normalized units (paper: GB); H100 preset: GiB of HBM (SI preset: bytes)


@dataclass(frozen=True)
class ProcPower:
    """Static + dynamic power model of one processor: busy power at
    execution speed ``s`` is ``static + dynamic * s**alpha`` (dynamic
    power ∝ s^α, α ≈ 2–3).  ``static`` is drawn for the whole schedule
    horizon, the dynamic term only while the processor computes."""

    static: float
    dynamic: float
    alpha: float = 2.0

    def __post_init__(self) -> None:
        if not (self.static >= 0 and self.dynamic >= 0):
            raise ValueError(
                f"power coefficients must be >= 0, got static="
                f"{self.static!r} dynamic={self.dynamic!r}")
        if not self.alpha >= 1:
            raise ValueError(
                f"speed-scaling exponent alpha must be >= 1, got {self.alpha!r}")

    def busy_watts(self, speed: float) -> float:
        """Power drawn while computing at ``speed``."""
        return self.static + self.dynamic * speed ** self.alpha

    def to_list(self) -> list:
        return [self.static, self.dynamic, self.alpha]


@dataclass
class Platform:
    """Computing system with k processors and uniform bandwidth β.

    ``link_bandwidth`` maps directed processor-index pairs ``(i, j)`` to a
    bandwidth overriding β on that link; ``failure_rates`` maps a processor
    index to its exponential failure rate and ``power`` to its
    :class:`ProcPower` (absent: never fails, unmetered).
    """

    procs: list[Processor]
    bandwidth: float = 1.0
    name: str = "cluster"
    link_bandwidth: dict[tuple[int, int], float] = field(default_factory=dict)
    failure_rates: dict[int, float] = field(default_factory=dict)
    power: dict[int, ProcPower] = field(default_factory=dict)

    @property
    def k(self) -> int:
        return len(self.procs)

    def speed(self, j: int) -> float:
        return self.procs[j].speed

    def memory(self, j: int) -> float:
        return self.procs[j].memory

    def sorted_by_memory(self) -> list[int]:
        """Processor indices by decreasing memory (ties: faster first)."""
        return sorted(range(self.k),
                      key=lambda j: (-self.procs[j].memory, -self.procs[j].speed))

    def max_memory(self) -> float:
        return max(p.memory for p in self.procs)

    def min_memory(self) -> float:
        return min(p.memory for p in self.procs)

    def bandwidth_between(self, i: int, j: int) -> float:
        """Bandwidth of the directed link ``i -> j``: a per-link override
        wins over the uniform β; data staying on a processor (``i == j``)
        moves at no cost."""
        if i == j:
            return math.inf
        return self.link_bandwidth.get((i, j), self.bandwidth)

    def failure_rate(self, j: int) -> float:
        """Exponential failure rate λ of processor ``j`` (0.0 without a
        failure model for it: it never fails)."""
        return self.failure_rates.get(j, 0.0)

    def proc_power(self, j: int) -> ProcPower | None:
        """Power model of processor ``j`` (``None`` when unmetered)."""
        return self.power.get(j)

    @property
    def has_failure_model(self) -> bool:
        return bool(self.failure_rates)

    @property
    def has_power_model(self) -> bool:
        return bool(self.power)

    def _with(self, procs, bandwidth=None, name=None, links=None, rates=None,
              power=None) -> "Platform":
        return Platform(list(procs), self.bandwidth if bandwidth is None else bandwidth,
                        self.name if name is None else name,
                        dict(self.link_bandwidth if links is None else links),
                        dict(self.failure_rates if rates is None else rates),
                        dict(self.power if power is None else power))

    def with_bandwidth(self, beta: float) -> "Platform":
        """Uniform-β rescale; per-link overrides are kept as they are."""
        return self._with(self.procs, beta, f"{self.name}@beta={beta}")

    def with_speed(self, j: int, speed: float) -> "Platform":
        """Processor ``j``'s speed replaced by ``speed``, everything else
        unchanged: the transform behind ``SpeedChange`` and
        :meth:`repro_torch.runtime.fault.StragglerMonitor.degraded_platform`."""
        if not 0 <= j < self.k:
            raise ValueError(f"processor {j} out of range for k={self.k}")
        if not speed > 0:
            raise ValueError(
                f"processor speed must be positive, got {speed!r} for processor {j}")
        procs = list(self.procs)
        procs[j] = replace(procs[j], speed=float(speed))
        return self._with(procs)

    def with_processors(self, procs: list[Processor]) -> "Platform":
        """``procs`` appended at the next indices (elastic scale-up), so
        existing overrides and index references stay valid."""
        return self._with(list(self.procs) + list(procs))

    def with_link_bandwidth(self, i: int, j: int, beta: float, *,
                            symmetric: bool = True) -> "Platform":
        """Link ``i -> j`` (and ``j -> i`` when ``symmetric``) overridden to
        ``beta`` > 0."""
        if not beta > 0:
            raise ValueError(f"link bandwidth must be positive, got {beta!r} for link {i} -> {j}")
        links = dict(self.link_bandwidth)
        links[(i, j)] = beta
        if symmetric:
            links[(j, i)] = beta
        return self._with(self.procs, links=links)

    def with_failure_rates(self, rates: dict[int, float], *,
                           merge: bool = True) -> "Platform":
        """Exponential failure rates attached: ``rates`` maps processor
        index -> λ (> 0, finite).  ``merge`` folds them into the existing
        rates (new entries win); ``merge=False`` replaces the whole model
        (``{}`` removes it)."""
        for j, lam in rates.items():
            if not 0 <= j < self.k:
                raise ValueError(
                    f"failure rate for processor {j} out of range for k={self.k}")
            if not (lam > 0 and math.isfinite(lam)):
                raise ValueError(
                    f"failure rate must be positive and finite, got {lam!r} for processor {j}")
        return self._with(self.procs,
                          rates={**self.failure_rates, **rates} if merge else dict(rates))

    def with_power(self, power: dict[int, ProcPower], *, merge: bool = True) -> "Platform":
        """Per-processor :class:`ProcPower` models attached (the merge and
        replace rules of :meth:`with_failure_rates`)."""
        for j, pw in power.items():
            if not 0 <= j < self.k:
                raise ValueError(
                    f"power model for processor {j} out of range for k={self.k}")
            if not isinstance(pw, ProcPower):
                raise TypeError(
                    f"power model for processor {j} must be a ProcPower, got {pw!r}")
        return self._with(self.procs, power={**self.power, **power} if merge else dict(power))

    def without(self, failed: set[int]) -> "Platform":
        """The platform after losing processors ``failed``: surviving link
        overrides, failure rates and power models are reindexed to the
        compacted numbering."""
        keep = [j for j in range(self.k) if j not in failed]
        new_index = {old: i for i, old in enumerate(keep)}
        links = {(new_index[a], new_index[b]): bw for (a, b), bw in self.link_bandwidth.items()
                 if a in new_index and b in new_index}
        rates = {new_index[j]: lam for j, lam in self.failure_rates.items() if j in new_index}
        power = {new_index[j]: pw for j, pw in self.power.items() if j in new_index}
        return Platform([self.procs[j] for j in keep], self.bandwidth, f"{self.name}-degraded",
                        links, rates, power)


# ---------------------------------------------------------------------- #
# The paper's clusters (§5.1.2).  (name, speed GHz, memory GB)
# ---------------------------------------------------------------------- #
_DEFAULT_KINDS = [
    ("local", 4.0, 16.0),
    ("A1", 32.0, 32.0),
    ("A2", 6.0, 64.0),
    ("N1", 12.0, 16.0),
    ("N2", 8.0, 8.0),
    ("C2", 32.0, 192.0),
]

_MORE_HET_KINDS = [
    ("local*", 2.0, 8.0),
    ("A1*", 64.0, 64.0),
    ("A2*", 3.0, 128.0),
    ("N1*", 24.0, 8.0),
    ("N2*", 4.0, 4.0),
    ("C2*", 64.0, 384.0),
]

_LESS_HET_KINDS = [
    ("local'", 8.0, 64.0),
    ("A1'", 16.0, 64.0),
    ("A2'", 12.0, 128.0),
    ("N1'", 12.0, 64.0),
    ("N2'", 16.0, 32.0),
    ("C2'", 16.0, 192.0),
]


def _build(kinds, copies: int, beta: float, name: str) -> Platform:
    procs = [Processor(f"{kind}-{i}", s, m) for kind, s, m in kinds for i in range(copies)]
    return Platform(procs, beta, name)


def default_cluster(beta: float = 1.0) -> Platform:
    """36 nodes: six of each kind of Table 2."""
    return _build(_DEFAULT_KINDS, 6, beta, "default")


def small_cluster(beta: float = 1.0) -> Platform:
    """18 nodes: three of each kind."""
    return _build(_DEFAULT_KINDS, 3, beta, "small")


def large_cluster(beta: float = 1.0) -> Platform:
    """60 nodes: ten of each kind."""
    return _build(_DEFAULT_KINDS, 10, beta, "large")


def more_het_cluster(beta: float = 1.0) -> Platform:
    return _build(_MORE_HET_KINDS, 6, beta, "MoreHet")


def less_het_cluster(beta: float = 1.0) -> Platform:
    return _build(_LESS_HET_KINDS, 6, beta, "LessHet")


def no_het_cluster(beta: float = 1.0) -> Platform:
    """Homogeneous: every node must hold the most demanding task, so all C2."""
    procs = [Processor(f"C2-{i}", 32.0, 192.0) for i in range(36)]
    return Platform(procs, beta, "NoHet")


# ---------------------------------------------------------------------- #
# H100 fleet presets.  speed = bf16 dense TFLOP/s of one card, memory = GiB
# of HBM, both spec (NVIDIA H100 SXM5 80 GB data sheet, kernels/cost.py),
# not measured.  The "-degraded" kind models a card that delivers less than
# its rate, one sharing its host with a noisy neighbour or held below its
# power limit (straggler mitigation treats it as a slower processor rather
# than excluding it): its factor is a modelling choice, not a measurement.
# ---------------------------------------------------------------------- #
_H100_TFLOPS = cost.PEAK_FLOPS["bf16"] / 1e12      # spec: 989 TFLOP/s bf16 dense
_H100_GIB = cost.HBM_BYTES / 2**30                 # spec: 80 GiB of HBM3
_DEGRADED_SPEED = 0.7                              # modelling choice: 70 % of the spec rate
H100_KINDS = {
    "h100": Processor("h100", _H100_TFLOPS, _H100_GIB),
    "h100-degraded": Processor("h100-degraded", _H100_TFLOPS * _DEGRADED_SPEED, _H100_GIB),
}
# spec: one card's share of the inter-node network (NDR InfiniBand, 400 Gb/s), GB/s
_LINK_GBPS = cost.LINK_BYTES / 1e9


def h100_fleet(spec: dict[str, int] | None = None, *,
               link_gbps: float = _LINK_GBPS) -> Platform:
    """A fleet of H100 cards: ``spec`` maps kind -> count, e.g.
    ``{"h100": 248, "h100-degraded": 8}`` (the default: 256 cards, the
    production mesh's).  Bandwidth is GB/s per link, uniform (the paper's
    β)."""
    if spec is None:
        spec = {"h100": 248, "h100-degraded": 8}
    procs = []
    for kind, count in spec.items():
        if kind not in H100_KINDS:
            raise ValueError(f"unknown H100 kind {kind!r}; known kinds: {sorted(H100_KINDS)}")
        if not isinstance(count, int) or count < 0:
            raise ValueError(f"H100 kind {kind!r} needs a count >= 0, got {count!r}")
        base = H100_KINDS[kind]
        procs.extend(replace(base, name=f"{base.name}-{i}") for i in range(count))
    return Platform(procs, link_gbps, "h100-fleet")


def h100_fleet_si(spec: dict[str, int] | None = None, *,
                  link_gbps: float = _LINK_GBPS) -> Platform:
    """:func:`h100_fleet` in SI units: FLOP/s, bytes and bytes/s, the
    units :mod:`repro_torch.core.modelgraph` emits."""
    base = h100_fleet(spec, link_gbps=link_gbps)
    procs = [Processor(p.name, p.speed * 1e12, p.memory * 2**30) for p in base.procs]
    return Platform(procs, link_gbps * 1e9, base.name)
