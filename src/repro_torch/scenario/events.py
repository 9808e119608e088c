"""Platform events: timed changes to the execution environment — the
port's copy of ``repro/scenario/events.py``.

Each event is a point-in-time transform of a
:class:`~repro_torch.core.platform.Platform`.  ``apply(platform)`` returns
``(new_platform, proc_map)`` where ``proc_map`` maps every old
processor index to its index on the new platform (``None`` for a
processor that no longer exists) — the reindexing contract that lets
:mod:`repro_torch.scenario` carry assignments across an event, and that the
composition property tests pin down (``without`` compacts indices,
everything else preserves them).  :class:`SpeedChange` is also what
:meth:`repro_torch.runtime.fault.StragglerMonitor.speed_events` emits.

The transforms compose the elastic :class:`Platform` methods
(:meth:`~repro_torch.core.platform.Platform.without`,
:meth:`~repro_torch.core.platform.Platform.with_speed`,
:meth:`~repro_torch.core.platform.Platform.with_link_bandwidth`,
:meth:`~repro_torch.core.platform.Platform.with_processors`), so per-link
bandwidth overrides survive failures and arrivals.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.core.platform import Platform, Processor

__all__ = [
    "EventTimelineError",
    "LinkDegrade",
    "PlatformEvent",
    "ProcArrival",
    "ProcFailure",
    "SpeedChange",
    "canonical_event_order",
    "event_from_dict",
    "event_sort_key",
    "validate_event_timeline",
]


class EventTimelineError(ValueError):
    """Structured timeline rejection raised at *build* time.

    ``index`` is the offending position in the event list, ``code`` a
    stable kind (``"bad-type"``, ``"non-finite-time"``,
    ``"negative-time"``, ``"unsorted"``, ``"unsorted-tie"``).
    :class:`Scenario
    <repro_torch.scenario.runner.Scenario>` construction (and the
    :mod:`repro_torch.service` event loop) enforce this invariant up
    front — an unsorted or non-finite timeline must fail loudly before
    any replanning starts, not misbehave mid-run.
    """

    def __init__(self, code: str, index: int, detail: str) -> None:
        self.code = code
        self.index = index
        self.detail = detail
        super().__init__(f"[{code}] event #{index}: {detail}")


#: canonical rank of an event kind *within* one timestamp: removals
#: first, then arrivals, then in-place parameter changes — any fixed
#: convention would do, but there must be exactly one so that a
#: fuzz-generated timeline replays identically after a JSON round-trip.
_KIND_RANK = {
    "proc_failure": 0,
    "proc_arrival": 1,
    "speed_change": 2,
    "link_degrade": 3,
}


def event_sort_key(ev: "PlatformEvent") -> tuple:
    """Total order over events: ``(time, kind rank, per-kind fields)``.

    Events at the *same* timestamp apply in list order (each sees the
    platform produced by the previous one), so two permutations of
    simultaneous events are different timelines.  This key defines the
    single canonical permutation; :func:`validate_event_timeline`
    rejects any other with code ``"unsorted-tie"`` and
    :func:`canonical_event_order` produces it.
    """
    rank = _KIND_RANK.get(ev.kind, len(_KIND_RANK))
    if isinstance(ev, ProcFailure):
        tail: tuple = (tuple(sorted(ev.procs)),)
    elif isinstance(ev, ProcArrival):
        tail = (tuple((p.name, p.speed, p.memory) for p in ev.procs),)
    elif isinstance(ev, SpeedChange):
        tail = (ev.proc, ev.factor)
    elif isinstance(ev, LinkDegrade):
        tail = (ev.src, ev.dst, ev.bandwidth, ev.symmetric)
    else:
        tail = ()
    return (ev.time, rank, ev.kind, tail)


def canonical_event_order(events: Sequence["PlatformEvent"],
                          ) -> list["PlatformEvent"]:
    """``events`` sorted into the canonical total order
    (:func:`event_sort_key`) that :func:`validate_event_timeline`
    accepts."""
    return sorted(events, key=event_sort_key)


def validate_event_timeline(events: Sequence["PlatformEvent"]) -> None:
    """Check ``events`` is a time-sorted list of finite, non-negative
    :class:`PlatformEvent` s — with simultaneous events in the
    canonical intra-timestamp order (:func:`event_sort_key`) — and
    raise :class:`EventTimelineError` if not."""
    prev = None
    prev_key = None
    for i, ev in enumerate(events):
        if not isinstance(ev, PlatformEvent):
            raise EventTimelineError(
                "bad-type", i, f"not a PlatformEvent: {ev!r}")
        if not math.isfinite(ev.time):
            raise EventTimelineError(
                "non-finite-time", i, f"time is {ev.time!r}")
        if ev.time < 0:
            raise EventTimelineError(
                "negative-time", i, f"time is {ev.time!r}")
        if prev is not None and ev.time < prev:
            raise EventTimelineError(
                "unsorted", i,
                f"time {ev.time!r} precedes event #{i - 1} "
                f"at {prev!r} — sort the timeline by time")
        key = event_sort_key(ev)
        if prev is not None and ev.time == prev and key < prev_key:
            raise EventTimelineError(
                "unsorted-tie", i,
                f"{ev.describe()!r} at t={ev.time!r} precedes "
                f"simultaneous event #{i - 1} in the canonical "
                f"intra-timestamp order — use canonical_event_order()")
        prev = ev.time
        prev_key = key


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
class ProcFailure(PlatformEvent):
    """Processors ``procs`` disappear at ``time`` (node loss)."""

    procs: frozenset[int] = frozenset()
    kind: str = field(default="proc_failure", init=False, repr=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        object.__setattr__(self, "procs", frozenset(self.procs))
        if not self.procs:
            raise ValueError("ProcFailure needs at least one processor")

    def apply(self, platform: Platform):
        bad = [j for j in self.procs if not 0 <= j < platform.k]
        if bad:
            raise ValueError(
                f"failed processor(s) {sorted(bad)} out of range for "
                f"k={platform.k}"
            )
        if len(self.procs) >= platform.k:
            raise ValueError("cannot fail every processor")
        keep = [j for j in range(platform.k) if j not in self.procs]
        new_index = {old: i for i, old in enumerate(keep)}
        proc_map = {j: new_index.get(j) for j in range(platform.k)}
        return platform.without(set(self.procs)), proc_map

    def describe(self) -> str:
        return f"fail proc(s) {sorted(self.procs)}"

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["procs"] = sorted(self.procs)
        return d


@dataclass(frozen=True)
class ProcArrival(PlatformEvent):
    """New processors join at ``time`` (elastic scale-up)."""

    procs: tuple[Processor, ...] = ()
    kind: str = field(default="proc_arrival", init=False, repr=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        object.__setattr__(self, "procs", tuple(self.procs))
        if not self.procs:
            raise ValueError("ProcArrival needs at least one processor")

    def apply(self, platform: Platform):
        return (platform.with_processors(list(self.procs)),
                _identity_map(platform))

    def describe(self) -> str:
        return f"add proc(s) {[p.name for p in self.procs]}"

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["procs"] = [[p.name, p.speed, p.memory] for p in self.procs]
        return d


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


@dataclass(frozen=True)
class LinkDegrade(PlatformEvent):
    """The ``src -> dst`` link (both directions when ``symmetric``)
    drops to ``bandwidth`` at ``time``."""

    src: int = 0
    dst: int = 1
    bandwidth: float = 1.0
    symmetric: bool = True
    kind: str = field(default="link_degrade", init=False, repr=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        if not self.bandwidth > 0:
            raise ValueError(
                f"link bandwidth must be positive, got {self.bandwidth}")

    def apply(self, platform: Platform):
        for j in (self.src, self.dst):
            if not 0 <= j < platform.k:
                raise ValueError(
                    f"processor {j} out of range for k={platform.k}")
        return (
            platform.with_link_bandwidth(self.src, self.dst,
                                         self.bandwidth,
                                         symmetric=self.symmetric),
            _identity_map(platform),
        )

    def describe(self) -> str:
        arrow = "<->" if self.symmetric else "->"
        return (f"link {self.src}{arrow}{self.dst} "
                f"beta={self.bandwidth:.3g}")

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(src=self.src, dst=self.dst, bandwidth=self.bandwidth,
                 symmetric=self.symmetric)
        return d


_EVENT_KINDS = {
    "proc_failure": lambda d: ProcFailure(
        time=d["time"], procs=frozenset(d["procs"])),
    "proc_arrival": lambda d: ProcArrival(
        time=d["time"],
        procs=tuple(Processor(n, s, m) for n, s, m in d["procs"])),
    "speed_change": lambda d: SpeedChange(
        time=d["time"], proc=d["proc"], factor=d["factor"]),
    "link_degrade": lambda d: LinkDegrade(
        time=d["time"], src=d["src"], dst=d["dst"],
        bandwidth=d["bandwidth"], symmetric=d["symmetric"]),
}


def event_from_dict(d: dict) -> PlatformEvent:
    """Rebuild an event from its :meth:`PlatformEvent.to_dict` record."""
    try:
        build = _EVENT_KINDS[d["kind"]]
    except KeyError:
        raise ValueError(f"unknown event kind {d.get('kind')!r}") from None
    return build(d)
