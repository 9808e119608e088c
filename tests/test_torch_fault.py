"""Port parity: the straggler hooks and the H100 fleet preset.

``StragglerMonitor.speed_events`` / ``degraded_platform`` of
``repro_torch.runtime.fault`` against the JAX monitor's on the inputs of
``tests/test_scenario.py::TestStragglerEvents`` and
``tests/test_substrates.py::TestStragglers``, field by field; the port's
degraded platform, converted in a few lines, fed to the scheduler
(``repro.core.schedule``); the preset's kinds, ``ValueError``s and SI units.
"""
import dataclasses

import pytest

from repro.core import Platform as JaxPlatform
from repro.core import Processor as JaxProcessor
from repro.core import generate_workflow, schedule, validate_mapping
from repro.runtime.fault import StragglerMonitor as JaxStragglerMonitor
from repro.scenario import SpeedChange as JaxSpeedChange
from repro_torch.core import H100_KINDS, Platform, Processor, h100_fleet, h100_fleet_si
from repro_torch.kernels import cost
from repro_torch.runtime import StragglerMonitor
from repro_torch.scenario import SpeedChange


def _monitors(times):
    """The port's and the JAX monitor fed the same step times."""
    ours, ref = StragglerMonitor(threshold=1.5), JaxStragglerMonitor(threshold=1.5)
    for _ in range(8):
        for host, t in enumerate(times):
            ours.record(host, t)
            ref.record(host, t)
    return ours, ref


def _platforms(k, links=None):
    procs = [(f"p{i}", 100.0, 10.0) for i in range(k)]
    return (Platform([Processor(*p) for p in procs], 1.0, link_bandwidth=dict(links or {})),
            JaxPlatform([JaxProcessor(*p) for p in procs], 1.0,
                        link_bandwidth=dict(links or {})))


def _same_platform(ours, ref):
    assert [dataclasses.astuple(p) for p in ours.procs] == [
        dataclasses.astuple(p) for p in ref.procs]
    assert (ours.bandwidth, ours.name, ours.link_bandwidth, ours.failure_rates) == (
        ref.bandwidth, ref.name, ref.link_bandwidth, ref.failure_rates)


def test_emits_speed_change_events():
    """tests/test_scenario.py::TestStragglerEvents::test_emits_speed_change_events."""
    ours, ref = _monitors((1.0, 1.1, 4.0))
    plat, jplat = _platforms(3)
    evs = ours.speed_events(plat, host_of_proc=lambda j: j, at=12.5)
    jevs = ref.speed_events(jplat, host_of_proc=lambda j: j, at=12.5)
    assert len(evs) == len(jevs) == 1
    (ev,), (jev,) = evs, jevs
    assert isinstance(ev, SpeedChange) and isinstance(jev, JaxSpeedChange)
    assert (ev.time, ev.proc, ev.factor, ev.kind) == (jev.time, jev.proc, jev.factor, jev.kind)
    assert ev.to_dict() == jev.to_dict()
    assert ev.time == 12.5 and ev.proc == 2 and ev.factor == pytest.approx(1.1 / 4.0)
    degraded, m = ev.apply(plat)
    jdegraded, jm = jev.apply(jplat)
    _same_platform(degraded, jdegraded)
    assert m == jm == {0: 0, 1: 1, 2: 2}
    assert degraded.speed(2) == pytest.approx(100.0 * 1.1 / 4.0)


def test_degraded_platform_composes_events():
    """tests/test_scenario.py::TestStragglerEvents::test_degraded_platform_composes_events:
    the speeds scaled, the link overrides kept, the name."""
    ours, ref = _monitors((1.0, 1.1, 4.0))
    links = {(0, 1): 0.5, (1, 0): 0.5}
    plat, jplat = _platforms(3, links)
    degraded = ours.degraded_platform(plat, host_of_proc=lambda j: j)
    _same_platform(degraded, ref.degraded_platform(jplat, host_of_proc=lambda j: j))
    assert degraded.speed(2) == pytest.approx(100.0 * 1.1 / 4.0) and degraded.speed(0) == 100.0
    assert degraded.link_bandwidth == links and degraded.name.endswith("-degraded")
    # the input platform is not modified, and no straggler gives it back
    assert plat.speed(2) == 100.0 and plat.name == "cluster"
    calm, _ = _monitors((1.0, 1.1, 1.2))
    assert calm.degraded_platform(plat, host_of_proc=lambda j: j) is plat
    assert calm.speed_events(plat, host_of_proc=lambda j: j) == []


def test_several_processors_of_one_host():
    """Two processors a host: both of the slow host's processors slow down,
    as in the JAX monitor."""
    ours, ref = _monitors((1.0, 4.0, 1.0))
    plat, jplat = _platforms(6)
    host = lambda j: j // 2  # noqa: E731
    evs, jevs = ours.speed_events(plat, host, at=1.0), ref.speed_events(jplat, host, at=1.0)
    assert [e.to_dict() for e in evs] == [e.to_dict() for e in jevs]
    assert [e.proc for e in evs] == [2, 3]
    _same_platform(ours.degraded_platform(plat, host), ref.degraded_platform(jplat, host))


def _to_scheduler(plat: Platform) -> JaxPlatform:
    """The port's platform as the scheduler's (``repro.core``) Platform."""
    return JaxPlatform([JaxProcessor(p.name, p.speed, p.memory) for p in plat.procs],
                       plat.bandwidth, plat.name, dict(plat.link_bandwidth),
                       dict(plat.failure_rates))


def test_degraded_platform_feeds_scheduler():
    """tests/test_substrates.py::TestStragglers::test_degraded_platform_feeds_scheduler,
    then the converted platform scheduled: the slow processor at a quarter
    of its speed, and a valid mapping of a workflow on it."""
    mon = StragglerMonitor(threshold=1.5)
    for _ in range(8):
        mon.record(0, 1.0)
        mon.record(1, 4.0)
    plat = Platform([Processor("a", 100.0, 10.0), Processor("b", 100.0, 10.0)], 1.0)
    degraded = mon.degraded_platform(plat, host_of_proc=lambda j: j)
    assert degraded.procs[0].speed == pytest.approx(100.0)
    assert degraded.procs[1].speed == pytest.approx(25.0)
    sched = _to_scheduler(degraded)
    wf = generate_workflow("blast", 40, seed=1, platform=sched)
    report = schedule(wf, sched)
    assert report.feasible and validate_mapping(wf, report.best) == []


def test_h100_fleet_kinds_counts_and_units():
    fleet = h100_fleet({"h100": 3, "h100-degraded": 2})
    assert [p.name for p in fleet.procs] == ["h100-0", "h100-1", "h100-2", "h100-degraded-0",
                                             "h100-degraded-1"]
    assert fleet.name == "h100-fleet" and fleet.bandwidth == cost.LINK_BYTES / 1e9
    # the spec values of kernels/cost.py, in TFLOP/s and GiB
    assert fleet.speed(0) == cost.PEAK_FLOPS["bf16"] / 1e12 == 989.0
    assert fleet.memory(0) == cost.HBM_BYTES / 2**30 == 80.0
    assert fleet.speed(3) < fleet.speed(0) and fleet.memory(3) == fleet.memory(0)
    si = h100_fleet_si({"h100": 3, "h100-degraded": 2}, link_gbps=25.0)
    assert [p.speed for p in si.procs] == [p.speed * 1e12 for p in h100_fleet(
        {"h100": 3, "h100-degraded": 2}).procs]
    assert si.speed(0) == cost.PEAK_FLOPS["bf16"] and si.memory(0) == cost.HBM_BYTES
    assert si.bandwidth == 25e9 and si.name == "h100-fleet"
    assert h100_fleet().k == 256 and set(H100_KINDS) == {"h100", "h100-degraded"}
    assert h100_fleet({"h100": 0}).k == 0


@pytest.mark.parametrize("spec,match", [
    ({"v5e": 4}, "unknown H100 kind"),
    ({"h100": -1}, "count >= 0"),
    ({"h100": 2.0}, "count >= 0"),
])
def test_h100_fleet_refuses_what_it_does_not_know(spec, match):
    with pytest.raises(ValueError, match=match):
        h100_fleet(spec)
    with pytest.raises(ValueError, match=match):
        h100_fleet_si(spec)


def test_platform_transforms_carry_links_rates_and_power():
    from repro_torch.core import ProcPower
    plat = Platform([Processor(f"p{i}", 1.0, 1.0) for i in range(3)], 2.0,
                    failure_rates={2: 0.1}, power={1: ProcPower(1.0, 2.0)})
    plat = plat.with_link_bandwidth(0, 2, 0.5)
    assert plat.link_bandwidth == {(0, 2): 0.5, (2, 0): 0.5} and plat.bandwidth == 2.0
    for out in (plat.with_speed(1, 3.0), plat.with_bandwidth(4.0),
                plat.with_processors([Processor("q", 1.0, 1.0)])):
        assert out.link_bandwidth == plat.link_bandwidth
        assert out.failure_rates == {2: 0.1} and set(out.power) == {1}
    gone = plat.without({1})
    assert gone.k == 2 and gone.link_bandwidth == {(0, 1): 0.5, (1, 0): 0.5}
    assert gone.failure_rates == {1: 0.1} and gone.power == {} and gone.name.endswith("-degraded")
    with pytest.raises(ValueError, match="positive"):
        plat.with_speed(0, 0.0)
    with pytest.raises(ValueError, match="out of range"):
        SpeedChange(time=0.0, proc=5, factor=0.5).apply(plat)
    with pytest.raises(ValueError, match="positive"):
        SpeedChange(time=0.0, proc=0, factor=0.0)
