"""Platform events — the port's copy of ``PlatformEvent`` and
``SpeedChange`` from ``repro/scenario/events.py``, what
:meth:`repro_torch.runtime.fault.StragglerMonitor.speed_events` emits.

An event is a point-in-time transform of a
:class:`~repro_torch.core.platform.Platform`: ``apply(platform)`` returns
``(new_platform, proc_map)``, where ``proc_map`` maps every old processor
index to its index on the new platform (a speed change keeps them all).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.platform import Platform

__all__ = ["PlatformEvent", "SpeedChange"]


@dataclass(frozen=True)
class PlatformEvent:
    """Base: something happens to the platform at ``time``."""

    time: float

    def __post_init__(self) -> None:
        if not (self.time >= 0) or self.time == float("inf"):
            raise ValueError(f"event time must be finite and >= 0, got {self.time}")

    # subclasses override
    kind: str = field(default="event", init=False, repr=False)

    def apply(self, platform: Platform) -> tuple[Platform, dict[int, int | None]]:
        raise NotImplementedError

    def describe(self) -> str:
        return self.kind

    def to_dict(self) -> dict:
        return {"kind": self.kind, "time": self.time, "detail": self.describe()}


def _identity_map(platform: Platform) -> dict[int, int | None]:
    return {j: j for j in range(platform.k)}


@dataclass(frozen=True)
class SpeedChange(PlatformEvent):
    """Processor ``proc``'s speed is scaled by ``factor`` at ``time``
    (straggler slowdown for ``factor < 1``, recovery for ``> 1``)."""

    proc: int = 0
    factor: float = 1.0
    kind: str = field(default="speed_change", init=False, repr=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        if not self.factor > 0:
            raise ValueError(f"speed factor must be positive, got {self.factor}")

    def apply(self, platform: Platform):
        if not 0 <= self.proc < platform.k:
            raise ValueError(f"processor {self.proc} out of range for k={platform.k}")
        new_speed = platform.speed(self.proc) * self.factor
        return platform.with_speed(self.proc, new_speed), _identity_map(platform)

    def describe(self) -> str:
        return f"proc {self.proc} speed x{self.factor:.3g}"

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["proc"] = self.proc
        d["factor"] = self.factor
        return d
