"""Pluggable communication models for the schedule-execution engine.

The engine (:mod:`repro_torch.sim.engine`) delegates *all* transfer timing to
a communication model.  A model is any object with this protocol::

    name: str                  # reported in SimReport.comm
    reset(platform)            # called once per engine run
    start(t, key, volume, src_proc, dst_proc)
    has_active() -> bool
    next_completion() -> (time, key) | None   # earliest, without popping
    complete() -> (time, key)                 # pop that completion

``key`` is the quotient edge ``(src_vid, dst_vid)``; completions must
come out in deterministic ``(time, key)`` order.  Register nothing —
pass an instance straight to :func:`repro_torch.sim.simulate(..., comm=...)`.

Two models ship:

* :class:`ContentionFreeComm` — the paper's model: every transfer gets
  the full link bandwidth, so its duration is exactly ``volume /
  bandwidth_between(src, dst)``.  This is the model under which the
  simulated makespan is bit-identical to the analytic bottom-weight
  makespan (the correctness anchor; see :mod:`repro_torch.sim.engine`).
* :class:`FairShareComm` — fluid max-min fair sharing: each transfer
  is constrained by its source's egress port, its destination's
  ingress port and the directed link, all defaulting to the platform's
  ``bandwidth_between``; concurrent transfers split each resource
  fairly (progressive-filling water-fill, recomputed at every transfer
  start/finish).  A block fanning out to many successors — free in the
  analytic model — serializes on its egress port here, which is the
  main source of the analytic-vs-simulated gap.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

from repro_torch.core.platform import Platform

__all__ = ["ContentionFreeComm", "FairShareComm", "resolve_comm"]


class ContentionFreeComm:
    """Paper model: dedicated bandwidth, duration ``volume / β_link``."""

    name = "contention-free"

    def reset(self, platform: Platform) -> None:
        self._bw = platform.bandwidth_between
        self._heap: list[tuple[float, tuple[int, int]]] = []

    def start(self, t: float, key: tuple[int, int], volume: float,
              src_proc: int, dst_proc: int) -> None:
        bw = self._bw(src_proc, dst_proc)
        # ``t + volume / bw`` — the exact float expression of the
        # analytic recursion's ``c / beta + l`` term (addition is
        # commutative in IEEE-754, so the operand order is immaterial
        # for the bit-exactness anchor).
        delay = 0.0 if math.isinf(bw) else volume / bw
        heapq.heappush(self._heap, (t + delay, key))

    def has_active(self) -> bool:
        return bool(self._heap)

    def next_completion(self) -> tuple[float, tuple[int, int]] | None:
        return self._heap[0] if self._heap else None

    def complete(self) -> tuple[float, tuple[int, int]]:
        return heapq.heappop(self._heap)


@dataclass
class _Flow:
    key: tuple[int, int]
    remaining: float
    resources: tuple
    rate: float = 0.0


class FairShareComm:
    """Fluid max-min fair sharing over egress / ingress / link capacity.

    Between events every active transfer progresses at the max-min fair
    rate of the current flow set; the allocation is recomputed whenever
    a transfer starts or finishes (piecewise-constant rates).  With a
    single active transfer this degenerates to the contention-free
    model.  ``egress`` / ``ingress`` / ``link`` select which resources
    constrain a flow; capacities default to the platform's
    ``bandwidth_between`` (per-proc ports use the uniform β).
    """

    def __init__(self, *, egress: bool = True, ingress: bool = True,
                 link: bool = True) -> None:
        if not (egress or ingress or link):
            raise ValueError("at least one resource class must be active")
        self.egress = egress
        self.ingress = ingress
        self.link = link

    @property
    def name(self) -> str:
        tags = [t for t, on in (("egress", self.egress),
                                ("ingress", self.ingress),
                                ("link", self.link)) if on]
        return "fair-share(" + "+".join(tags) + ")"

    # -------------------------------------------------------------- #
    def reset(self, platform: Platform) -> None:
        self._platform = platform
        self._flows: dict[tuple[int, int], _Flow] = {}
        self._t = 0.0
        self._next: tuple[float, tuple[int, int]] | None = None

    def _resources(self, sp: int, dp: int) -> tuple:
        if sp == dp:
            # data staying on a processor is not transferred: no port
            # or link consumption (the flow completes instantly, as in
            # the contention-free model)
            return ()
        r = []
        if self.egress:
            r.append(("out", sp))
        if self.ingress:
            r.append(("in", dp))
        if self.link:
            r.append(("lnk", sp, dp))
        return tuple(r)

    def _capacity(self, res: tuple) -> float:
        if res[0] == "lnk":
            return self._platform.bandwidth_between(res[1], res[2])
        return self._platform.bandwidth

    # -------------------------------------------------------------- #
    def _advance(self, t: float) -> None:
        dt = t - self._t
        if dt > 0.0:
            for f in self._flows.values():
                if not math.isinf(f.rate):
                    f.remaining = max(0.0, f.remaining - f.rate * dt)
                else:
                    f.remaining = 0.0
        self._t = t

    def _reallocate(self) -> None:
        """Max-min fair rates via progressive filling (water-fill)."""
        flows = self._flows
        if not flows:
            self._next = None
            return
        members: dict[tuple, list] = {}
        for f in flows.values():
            for r in f.resources:
                members.setdefault(r, []).append(f.key)
        headroom = {r: self._capacity(r) for r in members}
        unfixed = set(flows)
        while unfixed:
            best = None
            for r in sorted(members):
                live = [k for k in members[r] if k in unfixed]
                if not live:
                    continue
                h = headroom[r] / len(live)
                if best is None or h < best[0]:
                    best = (h, r, live)
            if best is None:  # every remaining flow only on inf resources
                for k in unfixed:
                    flows[k].rate = math.inf
                break
            h, _, live = best
            for k in live:
                f = flows[k]
                f.rate = h
                unfixed.discard(k)
                for rr in f.resources:
                    headroom[rr] = max(0.0, headroom[rr] - h)
        # earliest completion under the new rates, ties by edge key
        nxt = None
        for k in sorted(flows):
            f = flows[k]
            done = self._t if (f.remaining <= 0.0 or math.isinf(f.rate)) \
                else self._t + f.remaining / f.rate
            if nxt is None or done < nxt[0]:
                nxt = (done, k)
        self._next = nxt

    # -------------------------------------------------------------- #
    def start(self, t: float, key: tuple[int, int], volume: float,
              src_proc: int, dst_proc: int) -> None:
        self._advance(t)
        self._flows[key] = _Flow(key, volume, self._resources(src_proc,
                                                              dst_proc))
        self._reallocate()

    def has_active(self) -> bool:
        return bool(self._flows)

    def next_completion(self) -> tuple[float, tuple[int, int]] | None:
        return self._next

    def complete(self) -> tuple[float, tuple[int, int]]:
        t, key = self._next
        self._advance(t)
        del self._flows[key]
        self._reallocate()
        return t, key


_ALIASES = {
    "contention-free": ContentionFreeComm,
    "paper": ContentionFreeComm,
    "analytic": ContentionFreeComm,
    "beta": ContentionFreeComm,
    "fair-share": FairShareComm,
    "fairshare": FairShareComm,
    "contention": FairShareComm,
}


def resolve_comm(comm) -> object:
    """A comm-model instance from a name, class or ready instance."""
    if isinstance(comm, str):
        try:
            return _ALIASES[comm]()
        except KeyError:
            raise ValueError(
                f"unknown comm model {comm!r}; choose from "
                f"{sorted(_ALIASES)} or pass an instance"
            ) from None
    if isinstance(comm, type):
        return comm()
    return comm
