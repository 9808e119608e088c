"""Fault-tolerance primitives — port of ``repro/runtime/fault.py``.

* :class:`FailureInjector` — deterministic fault injection for tests
  (raise at given steps),
* :func:`run_with_restarts` — supervisor loop: run, catch, restore from
  the latest checkpoint, resume; gives up after ``max_restarts``,
* :class:`StragglerMonitor` — per-host step-time statistics that flag
  outliers, give each straggler's measured speed factor, and turn the
  factors into ``SpeedChange`` events and a degraded
  :class:`~repro_torch.core.platform.Platform` (slow hosts as slower
  processors), the input a scheduler re-plans on,
* :class:`StepTimer` — wall time between laps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["FailureInjector", "run_with_restarts", "StragglerMonitor",
           "SimulatedFault", "StepTimer"]


class SimulatedFault(RuntimeError):
    """Raised by the injector — stands in for a lost host/preemption."""


@dataclass
class FailureInjector:
    fail_at_steps: tuple[int, ...] = ()
    max_failures: int = 1
    _count: int = 0

    def check(self, step: int) -> None:
        if self._count < self.max_failures and step in self.fail_at_steps:
            self._count += 1
            raise SimulatedFault(f"injected fault at step {step}")


def run_with_restarts(make_state, run, *, max_restarts: int = 3,
                      on_restart=None):
    """Supervisor: ``state = make_state()`` then ``run(state)``.

    ``run`` must be resumable — it reloads progress from checkpoints via
    ``make_state``.  Returns ``(result, n_restarts)``.
    """
    restarts = 0
    while True:
        state = make_state()
        try:
            return run(state), restarts
        except SimulatedFault:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts)


@dataclass
class StragglerMonitor:
    """Rolling per-step wall-time statistics with outlier detection.

    Each host reports its step time; a host whose median exceeds
    ``threshold`` x the median of the hosts' medians is flagged.
    """

    threshold: float = 1.5
    window: int = 32
    times: dict[int, list[float]] = field(default_factory=dict)

    def record(self, host: int, seconds: float) -> None:
        buf = self.times.setdefault(host, [])
        buf.append(seconds)
        if len(buf) > self.window:
            del buf[0]

    def _medians(self) -> dict[int, float]:
        meds = {}
        for host, buf in self.times.items():
            s = sorted(buf)
            meds[host] = s[(len(s) - 1) // 2]  # lower median
        return meds

    def stragglers(self) -> list[int]:
        return sorted(self.slowdown_factors())

    def slowdown_factors(self) -> dict[int, float]:
        """Per-straggler speed factor ``overall_median / host_median``
        (< 1/threshold by construction): the fraction of nominal speed
        a straggling host is actually delivering."""
        meds = self._medians()
        if len(meds) < 2:
            return {}
        overall = sorted(meds.values())[(len(meds) - 1) // 2]
        return {
            h: overall / m
            for h, m in meds.items()
            if m > self.threshold * overall
        }

    def speed_events(self, platform, host_of_proc, *, at: float = 0.0):
        """The measured slowdowns as :class:`repro_torch.scenario.SpeedChange`
        events at time ``at``: one for each processor ``j`` of ``platform``
        whose host ``host_of_proc(j)`` straggles."""
        from repro_torch.scenario import SpeedChange

        factors = self.slowdown_factors()
        return [SpeedChange(time=at, proc=j, factor=factors[host_of_proc(j)])
                for j in range(platform.k) if host_of_proc(j) in factors]

    def degraded_platform(self, platform, host_of_proc):
        """``platform`` with each straggler processor's speed scaled by its
        measured slowdown, named ``<name>-degraded``: the events of
        :meth:`speed_events` applied in turn, so per-link bandwidth
        overrides, failure rates and power models are kept.  The platform
        itself when no host straggles."""
        events = self.speed_events(platform, host_of_proc)
        if not events:
            return platform
        out = platform
        for ev in events:
            out, _ = ev.apply(out)
        out.name = platform.name + "-degraded"
        return out


class StepTimer:
    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
