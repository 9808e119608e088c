"""Heterogeneous execution environments — the port's copy of what its
straggler hooks and its fleet preset need from ``repro/core/platform.py``.

A platform is a set of processors, each with its own memory size and
speed, plus a uniform interconnect bandwidth ``β``.  Directed links may
override ``β`` (:meth:`Platform.with_link_bandwidth`); failure rates and
power models are optional, sparse maps by processor index.  Every elastic
transform carries all three: :meth:`Platform.with_speed`,
:meth:`Platform.with_processors`, :meth:`Platform.with_bandwidth` and
:meth:`Platform.with_link_bandwidth` keep them, :meth:`Platform.without`
reindexes the surviving entries.

:func:`h100_fleet` / :func:`h100_fleet_si` are the port's fleet presets,
the counterparts of the reference's TPU presets, with the same kind ->
count contract: a processor is one NVIDIA H100 SXM5 80 GB.  Their rates
and bytes are the data sheet's (``kernels/cost.py``, the port's one copy
of them): spec values, not measurements.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.kernels import cost

__all__ = ["Processor", "ProcPower", "Platform", "H100_KINDS", "h100_fleet", "h100_fleet_si"]


@dataclass(frozen=True)
class Processor:
    name: str
    speed: float   # normalized ops/s; H100 preset: TFLOP/s (SI preset: FLOP/s)
    memory: float  # normalized units; H100 preset: GiB of HBM (SI preset: bytes)


@dataclass(frozen=True)
class ProcPower:
    """Static + dynamic power model of one processor: busy power at
    execution speed ``s`` is ``static + dynamic * s**alpha``."""

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

    def _with(self, procs, bandwidth=None, name=None, links=None) -> "Platform":
        return Platform(list(procs), self.bandwidth if bandwidth is None else bandwidth,
                        self.name if name is None else name,
                        dict(self.link_bandwidth if links is None else links),
                        dict(self.failure_rates), dict(self.power))

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
    """:func:`h100_fleet` in SI units: FLOP/s, bytes and bytes/s."""
    base = h100_fleet(spec, link_gbps=link_gbps)
    procs = [Processor(p.name, p.speed * 1e12, p.memory * 2**30) for p in base.procs]
    return Platform(procs, link_gbps * 1e9, base.name)
