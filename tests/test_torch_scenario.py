"""The port's scenario engine, ``repro_torch.scenario``, with its elastic
consumers.

Every case of ``tests/test_scenario.py`` on the port alone (engine
pause/resume, warm-start replanning, timeline stitching, migration
accounting, the straggler monitor's events and ``rescale_plan``, on
``h100_fleet_si`` where the reference uses ``tpu_fleet_si``), and of
``tests/test_platform_transforms.py`` (the transforms' composition and
reindexing, property-tested as there).

Then parity with ``repro.scenario`` and ``repro.runtime.rescale_plan`` on
the same seeded inputs, each package on its own objects (platforms and
events bridged by value): ``run_scenario``'s ``TimelineReport.to_json``
byte for byte for each event kind under the three policies (wall-clock
fields set aside), the straggler monitor's events driving a timeline, and
``rescale_plan`` on H100 fleets.
"""
import json

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # pragma: no cover
    from _hypothesis_fallback import given, settings, st

from repro_torch.core import (
    Platform,
    ProcPower,
    Processor,
    ResumeState,
    Scheduler,
    SchedulerConfig,
    Workflow,
    default_cluster,
    generate_workflow,
    h100_fleet_si,
    residual_workflow,
    schedule,
    validate_mapping,
)
from repro_torch.runtime.fault import StragglerMonitor
from repro_torch.scenario import (
    LinkDegrade,
    ProcArrival,
    ProcFailure,
    Scenario,
    SpeedChange,
    TimelineReport,
    event_from_dict,
    run_scenario,
)
from repro_torch.sim import build_specs, resolve_comm, resume_engine, run_engine

from _torch_parity import (  # noqa: F401 (fresh_metrics is a fixture)
    events_as,
    fresh_metrics,
    platform_as,
    untimed_timeline_json,
)


@pytest.fixture
def diamond() -> Workflow:
    """1 -> {2, 3} -> 4 diamond with distinct weights (the port's
    ``Workflow``; the shared fixture builds the JAX package's)."""
    wf = Workflow(4)
    wf.work[:] = [4.0, 1.0, 3.0, 1.0]
    wf.mem[:] = [2.0, 1.0, 1.0, 2.0]
    wf.add_edge(0, 1, 1.0)
    wf.add_edge(0, 2, 2.0)
    wf.add_edge(1, 3, 1.0)
    wf.add_edge(2, 3, 1.0)
    return wf


KPRIME = [2, 4, 9]


def _wf(family="montage", n=200, seed=1, plat=None):
    return generate_workflow(family, n, seed=seed,
                             platform=plat or default_cluster())


# ---------------------------------------------------------------------- #
# engine pause / resume
# ---------------------------------------------------------------------- #
class TestEnginePause:
    @pytest.fixture(scope="class")
    def specs(self):
        plat = default_cluster()
        wf = _wf("epigenomics", 300, 2, plat)
        res = schedule(wf, plat, kprime=[6]).best
        blocks, edges = build_specs(res.quotient, plat)
        return plat, blocks, edges

    @pytest.mark.parametrize("comm", ["contention-free", "fair-share"])
    def test_pause_resume_bit_identical(self, specs, comm):
        plat, blocks, edges = specs
        full = run_engine(blocks, edges, resolve_comm(comm), plat)
        tr = run_engine(blocks, edges, resolve_comm(comm), plat,
                        stop_time=full.horizon * 0.3)
        assert tr.paused
        # pause freezes exactly the <= stop_time prefix
        cut = full.horizon * 0.3
        assert set(tr.finish) == {v for v, t in full.finish.items()
                                  if t <= cut}
        tr = resume_engine(tr.checkpoint, stop_time=full.horizon * 0.7)
        assert tr.paused
        tr = resume_engine(tr.checkpoint)
        assert not tr.paused
        assert tr.start == full.start
        assert tr.finish == full.finish
        assert tr.xfer_start == full.xfer_start
        assert tr.xfer_finish == full.xfer_finish
        assert tr.horizon == full.horizon

    def test_in_flight_classification(self, specs):
        plat, blocks, edges = specs
        full = run_engine(blocks, edges, resolve_comm("contention-free"),
                          plat)
        cut = full.horizon * 0.5
        tr = run_engine(blocks, edges, resolve_comm("contention-free"),
                        plat, stop_time=cut)
        for v in tr.in_flight():
            assert full.start[v] <= cut < full.finish[v]

    def test_stop_past_horizon_completes(self, specs):
        plat, blocks, edges = specs
        full = run_engine(blocks, edges, resolve_comm("contention-free"),
                          plat)
        tr = run_engine(blocks, edges, resolve_comm("contention-free"),
                        plat, stop_time=full.horizon * 2)
        assert not tr.paused and tr.finish == full.finish

    def test_resume_rejects_earlier_stop(self, specs):
        plat, blocks, edges = specs
        tr = run_engine(blocks, edges, resolve_comm("contention-free"),
                        plat, stop_time=10.0)
        if tr.paused:
            with pytest.raises(ValueError, match="precedes"):
                resume_engine(tr.checkpoint, stop_time=1.0)


# ---------------------------------------------------------------------- #
# residual extraction
# ---------------------------------------------------------------------- #
class TestResidualWorkflow:
    def test_requirement_preserved_on_frontier(self, diamond):
        sub, mapping = residual_workflow(diamond, {0})
        assert mapping == [1, 2, 3]
        # frontier tasks keep their full requirement: the boundary
        # input volume is folded into task memory
        for i, u in enumerate(mapping):
            assert sub.task_requirement(i) == pytest.approx(
                diamond.task_requirement(u))
        assert sorted(sub.sources()) == [0, 1]  # old tasks 1 and 2

    def test_rejects_non_closed_prefix(self, diamond):
        with pytest.raises(ValueError, match="closed under predecessors"):
            residual_workflow(diamond, {3})

    def test_empty_completed_is_identity_shape(self, diamond):
        sub, mapping = residual_workflow(diamond, set())
        assert mapping == [0, 1, 2, 3]
        assert sub.n_edges == diamond.n_edges


# ---------------------------------------------------------------------- #
# the identity anchor
# ---------------------------------------------------------------------- #
class TestIdentityAnchor:
    def test_empty_timeline_matches_schedule(self):
        plat = default_cluster()
        wf = _wf()
        cfg = SchedulerConfig(kprime=KPRIME, simulate=True)
        plain = Scheduler(cfg).schedule(wf, plat)
        tl = run_scenario(Scenario(wf, plat, []), config=cfg)
        assert tl.feasible and len(tl.segments) == 1
        # bit-exact: same best makespan, same simulated makespan
        assert tl.segments[0].report.makespan == plain.makespan
        assert tl.makespan == plain.sim.makespan
        assert tl.migrations == [] and tl.replan_times_s == []

    def test_event_after_completion_is_noop(self):
        plat = default_cluster()
        wf = _wf()
        cfg = SchedulerConfig(kprime=KPRIME)
        plain = Scheduler(cfg).schedule(wf, plat)
        tl = run_scenario(
            Scenario(wf, plat, [ProcFailure(plain.makespan * 10, {0})]),
            config=cfg)
        assert tl.feasible and len(tl.segments) == 1
        assert tl.makespan == pytest.approx(plain.makespan)


# ---------------------------------------------------------------------- #
# failure scenarios + policies
# ---------------------------------------------------------------------- #
class TestFailureScenarios:
    @pytest.fixture(scope="class")
    def setting(self):
        plat = default_cluster()
        wf = _wf("montage", 200, 1, plat)
        cfg = SchedulerConfig(kprime=KPRIME)
        base = Scheduler(cfg).schedule(wf, plat)
        q = base.best.quotient
        used = sorted({q.proc[v] for v in q.members})
        te = 0.4 * base.makespan
        return plat, wf, cfg, base, used, te

    def test_warm_start_freezes_completed_and_pins_inflight(self, setting):
        plat, wf, cfg, base, used, te = setting
        sc = Scenario(wf, plat, [ProcFailure(te, frozenset(used[:2]))])
        tl = run_scenario(sc, "pinned-warm-start", config=cfg)
        assert tl.feasible and len(tl.segments) == 2
        assert tl.validate() == []  # memory_trace=True per segment

        seg0, seg1 = tl.segments
        cut = seg0.executed_until
        sim0 = seg0.sim
        q0 = seg0.mapping.quotient
        completed = {v for v, f in sim0.block_finish.items() if f <= cut}
        inflight = {v for v, s in sim0.block_start.items()
                    if s < cut and v not in completed}
        done_tasks = set()
        for v in completed:
            done_tasks |= {seg0.task_ids[u] for u in q0.members[v]}
        # completed tasks left the workflow for good
        assert done_tasks.isdisjoint(seg1.task_ids)
        assert seg1.completed_before == len(done_tasks)

        # in-flight blocks on surviving processors stay put (by name)
        q1 = seg1.mapping.quotient
        inv1 = {g: i for i, g in enumerate(seg1.task_ids)}
        proc_name1 = {}
        for vid, members in q1.members.items():
            nm = seg1.platform.procs[q1.proc[vid]].name
            for u in members:
                proc_name1[u] = nm
        failed_names = {plat.procs[j].name for j in used[:2]}
        for v in inflight:
            old_name = plat.procs[q0.proc[v]].name
            if old_name in failed_names:
                continue  # displaced, not pinned
            for u in q0.members[v]:
                assert proc_name1[inv1[seg0.task_ids[u]]] == old_name

        # migration log agrees on the restart accounting (moved_tasks
        # may be > 0: Step 4 is free to improve *unstarted* blocks)
        m = tl.migrations[0]
        assert m.restarted_blocks == len(inflight)
        assert m.restarted_tasks == sum(len(q0.members[v])
                                        for v in inflight)
        assert m.lost_work > 0

    def test_full_replan_feasible_and_valid(self, setting):
        plat, wf, cfg, base, used, te = setting
        sc = Scenario(wf, plat, [ProcFailure(te, frozenset(used[:2]))])
        tl = run_scenario(sc, "full-replan", config=cfg)
        assert tl.feasible
        assert tl.validate() == []
        assert tl.segments[-1].report.algorithm == "dag_het_part"

    def test_no_replan_structured_infeasibility_on_failure(self, setting):
        plat, wf, cfg, base, used, te = setting
        sc = Scenario(wf, plat, [ProcFailure(te, frozenset(used[:2]))])
        tl = run_scenario(sc, "no-replan", config=cfg)
        assert not tl.feasible
        assert tl.makespan is None
        assert tl.failed_at == pytest.approx(te)
        assert tl.infeasibility is not None

    def test_no_replan_survives_untouched_failure(self, setting):
        plat, wf, cfg, base, used, te = setting
        idle = [j for j in range(plat.k) if j not in used]
        sc = Scenario(wf, plat, [ProcFailure(te, frozenset(idle[:1]))])
        tl = run_scenario(sc, "no-replan", config=cfg)
        assert tl.feasible
        assert tl.migrations[0].moved_tasks == 0
        assert tl.migrations[0].displaced_tasks == 0

    def test_speed_change_replans_feasibly(self, setting):
        plat, wf, cfg, base, used, te = setting
        events = [SpeedChange(te, proc=used[0], factor=0.25)]
        tl = run_scenario(Scenario(wf, plat, events),
                          "pinned-warm-start", config=cfg)
        assert tl.feasible and tl.validate() == []
        assert tl.segments[1].platform.speed(used[0]) == pytest.approx(
            plat.speed(used[0]) * 0.25)

    def test_link_degrade_and_arrival_chain(self, setting):
        plat, wf, cfg, base, used, te = setting
        events = [
            LinkDegrade(te, src=used[0], dst=used[1], bandwidth=0.05),
            ProcArrival(te * 1.5,
                        procs=(Processor("fresh-0", 64.0, 256.0),)),
        ]
        tl = run_scenario(Scenario(wf, plat, events),
                          "pinned-warm-start", config=cfg)
        assert tl.feasible and tl.validate() == []
        assert tl.segments[-1].platform.k == plat.k + 1

    def test_inflight_transfer_never_silently_dropped(self):
        # A(20) --100--> B(10) on two unit-speed procs: makespan 130.
        # A no-op event at t=50 lands mid-transfer; A's output is not
        # durable yet, so A restarts — the stitched makespan must never
        # undercut the no-event one (a dropped transfer once made it 60)
        wf = Workflow(2)
        wf.work[:] = [20.0, 10.0]
        wf.mem[:] = [1.0, 1.0]
        wf.add_edge(0, 1, 100.0)
        plat = Platform([Processor("a", 1.0, 1e6),
                         Processor("b", 1.0, 1e6)], 1.0)
        cfg = SchedulerConfig(kprime=[2])
        base = Scheduler(cfg).schedule(wf, plat)
        assert base.makespan == pytest.approx(130.0)
        sc = Scenario(wf, plat, [SpeedChange(50.0, proc=0, factor=1.0)])
        tl = run_scenario(sc, "no-replan", config=cfg,
                          initial_report=base)
        assert tl.feasible
        assert tl.makespan >= base.makespan  # no silent transfer drop
        assert tl.makespan == pytest.approx(50.0 + 130.0)  # restart
        m = tl.migrations[0]
        assert m.restarted_blocks == 1  # A: delivered nothing durable
        assert m.lost_work == pytest.approx(20.0)  # its full compute
        # whereas an event after the transfer landed freezes A for
        # good: only B (mid-compute at t=125) restarts -> 125 + 10
        sc2 = Scenario(wf, plat, [SpeedChange(125.0, proc=0, factor=1.0)])
        tl2 = run_scenario(sc2, "no-replan", config=cfg,
                           initial_report=base)
        assert tl2.makespan == pytest.approx(125.0 + 10.0)
        assert tl2.migrations[0].restarted_blocks == 1  # B mid-compute
        assert tl2.segments[1].completed_before == 1    # A frozen

    def test_pipeline_sim_options_govern_pause_model(self, setting):
        # cfg.simulate reuses the pipeline SimReport; a conflicting
        # caller-side sim_options must not leak into the pause engine
        plat, wf, cfg, base, used, te = setting
        from dataclasses import replace
        cfg_sim = replace(cfg, simulate=True)
        sc = Scenario(wf, plat, [ProcFailure(te, frozenset(used[:1]))])
        tl = run_scenario(sc, "warm+fallback", config=cfg_sim,
                          sim_options={"comm": "fair-share"})
        assert tl.feasible
        for seg in tl.segments:
            assert seg.sim.comm == "contention-free"

    def test_warm_cold_fallback_rescues_infeasible_warm(self):
        # full-sweep montage mapping where failing the 4 fastest used
        # processors strands a 192-requirement block: the pure warm
        # start is structurally infeasible (no split in warm mode),
        # the fallback escalates to a cold replan and completes
        plat = default_cluster()
        wf = _wf("montage", 200, 1, plat)
        cfg = SchedulerConfig(kprime=[1, 2, 4, 6, 9, 13, 19, 28, 36])
        base = Scheduler(cfg).schedule(wf, plat)
        q = base.best.quotient
        fastest = sorted({q.proc[v] for v in q.members},
                         key=lambda j: -plat.speed(j))[:4]
        sc = Scenario(wf, plat,
                      [ProcFailure(0.1 * base.makespan,
                                   frozenset(fastest))])
        warm = run_scenario(sc, "pinned-warm-start", config=cfg,
                            initial_report=base)
        assert not warm.feasible
        assert warm.infeasibility.stage == "merge"
        rescued = run_scenario(sc, "warm+fallback", config=cfg,
                               initial_report=base)
        assert rescued.feasible and rescued.validate() == []
        assert rescued.policy == "pinned-warm-start+cold-fallback"

    def test_infeasible_initial_plan_is_structured(self):
        tiny = Platform([Processor("p0", 1.0, 1.0),
                         Processor("p1", 1.0, 1.0)], 1.0)
        wf = _wf("blast", 60, 3)  # memories far above 1.0
        tl = run_scenario(Scenario(wf, tiny, [ProcFailure(5.0, {0})]),
                          config=SchedulerConfig(kprime=[1, 2]))
        assert not tl.feasible and tl.segments == []
        assert tl.failed_at == 0.0 and tl.infeasibility is not None

    def test_json_roundtrip_and_gantt(self, setting):
        plat, wf, cfg, base, used, te = setting
        sc = Scenario(wf, plat, [ProcFailure(te, frozenset(used[:2]))])
        tl = run_scenario(sc, "pinned-warm-start", config=cfg)
        back = TimelineReport.from_json(tl.to_json())
        assert back.makespan == tl.makespan
        assert back.policy == tl.policy
        assert len(back.segments) == len(tl.segments)
        assert [m.to_dict() for m in back.migrations] == \
            [m.to_dict() for m in tl.migrations]
        g = tl.gantt(width=48)
        assert "▼" in g and "░" not in g.split("\n")[0]
        # deserialized reports flag missing live mappings, not crash
        assert any("live mapping" in e for e in back.validate())


# ---------------------------------------------------------------------- #
# Scheduler.resume / warm-start mode
# ---------------------------------------------------------------------- #
class TestSchedulerResume:
    def test_resume_of_own_partition_reproduces_makespan(self):
        plat = default_cluster()
        wf = _wf()
        rep = schedule(wf, plat, kprime=KPRIME)
        q = rep.best.quotient
        vids = sorted(q.members)
        state = ResumeState(
            wf=wf, platform=plat,
            blocks=[sorted(q.members[v]) for v in vids],
            proc_of_block=[q.proc[v] for v in vids])
        warm = Scheduler(SchedulerConfig()).resume(state)
        assert warm.feasible
        assert warm.algorithm == "warm_start"
        # Step 4 already converged in the cold run: no further gain,
        # and the warm result must still be valid
        assert warm.makespan <= rep.makespan
        assert validate_mapping(wf, warm.best) == []

    def test_pinned_blocks_never_move(self):
        plat = default_cluster()
        wf = _wf("bwa", 150, 4, plat)
        rep = schedule(wf, plat, kprime=KPRIME)
        q = rep.best.quotient
        vids = sorted(q.members)
        pinned = set(range(len(vids)))  # pin everything
        state = ResumeState(
            wf=wf, platform=plat,
            blocks=[sorted(q.members[v]) for v in vids],
            proc_of_block=[q.proc[v] for v in vids],
            pinned=pinned)
        warm = Scheduler(SchedulerConfig()).resume(state)
        assert warm.feasible
        q2 = warm.best.quotient
        for i, v in enumerate(vids):
            members = set(q.members[v])
            match = [v2 for v2, m2 in q2.members.items()
                     if members <= m2]
            assert len(match) == 1
            assert q2.proc[match[0]] == q.proc[v]

    def test_resume_state_validates_pins(self):
        wf = _wf("blast", 20, 0)
        plat = default_cluster()
        with pytest.raises(ValueError, match="pin"):
            ResumeState(wf=wf, platform=plat,
                        blocks=[list(range(wf.n))],
                        proc_of_block=[None], pinned={0})

    def test_orphaned_block_rehomed_or_structured_failure(self):
        plat = default_cluster()
        wf = _wf()
        rep = schedule(wf, plat, kprime=KPRIME)
        q = rep.best.quotient
        vids = sorted(q.members)
        procs = [q.proc[v] for v in vids]
        procs[0] = None  # orphan one block
        state = ResumeState(
            wf=wf, platform=plat,
            blocks=[sorted(q.members[v]) for v in vids],
            proc_of_block=procs)
        warm = Scheduler(SchedulerConfig()).resume(state)
        assert warm.feasible  # plenty of idle processors to re-home to
        assert validate_mapping(wf, warm.best) == []


# ---------------------------------------------------------------------- #
# events
# ---------------------------------------------------------------------- #
class TestEvents:
    def test_roundtrip(self):
        evs = [
            ProcFailure(3.0, frozenset({1, 4})),
            ProcArrival(5.0, (Processor("x", 2.0, 8.0),)),
            SpeedChange(7.0, proc=2, factor=0.5),
            LinkDegrade(9.0, src=0, dst=3, bandwidth=0.1,
                        symmetric=False),
        ]
        for e in evs:
            back = event_from_dict(json.loads(json.dumps(e.to_dict())))
            assert back == e

    def test_validation(self):
        with pytest.raises(ValueError):
            ProcFailure(-1.0, {0})
        with pytest.raises(ValueError):
            ProcFailure(1.0, frozenset())
        with pytest.raises(ValueError):
            SpeedChange(1.0, proc=0, factor=0.0)
        with pytest.raises(ValueError):
            LinkDegrade(1.0, src=0, dst=1, bandwidth=-2.0)
        plat = Platform([Processor("a", 1.0, 1.0),
                         Processor("b", 1.0, 1.0)], 1.0)
        with pytest.raises(ValueError, match="every processor"):
            ProcFailure(0.0, {0, 1}).apply(plat)
        with pytest.raises(ValueError, match="out of range"):
            SpeedChange(0.0, proc=9, factor=0.5).apply(plat)

    def test_failure_proc_map_compacts(self):
        plat = default_cluster()
        new, m = ProcFailure(0.0, {1, 3}).apply(plat)
        assert new.k == plat.k - 2
        assert m[1] is None and m[3] is None
        assert m[0] == 0 and m[2] == 1 and m[4] == 2
        assert new.procs[m[4]].name == plat.procs[4].name


# ---------------------------------------------------------------------- #
# straggler monitor -> scenario events
# ---------------------------------------------------------------------- #
class TestStragglerEvents:
    def _monitor(self):
        mon = StragglerMonitor(threshold=1.5)
        for _ in range(8):
            mon.record(0, 1.0)
            mon.record(1, 1.1)
            mon.record(2, 4.0)
        return mon

    def test_median_based_slowdown_factor(self):
        mon = self._monitor()
        factors = mon.slowdown_factors()
        # overall lower median of {1.0, 1.1, 4.0} is 1.1; only host 2
        # exceeds 1.5x it, delivering 1.1/4.0 of nominal speed
        assert set(factors) == {2}
        assert factors[2] == pytest.approx(1.1 / 4.0)

    def test_emits_speed_change_events(self):
        mon = self._monitor()
        plat = Platform([Processor(f"p{i}", 100.0, 10.0)
                         for i in range(3)], 1.0)
        evs = mon.speed_events(plat, host_of_proc=lambda j: j, at=12.5)
        assert len(evs) == 1
        (ev,) = evs
        assert isinstance(ev, SpeedChange)
        assert ev.time == 12.5 and ev.proc == 2
        assert ev.factor == pytest.approx(1.1 / 4.0)
        degraded, m = ev.apply(plat)
        assert degraded.speed(2) == pytest.approx(100.0 * 1.1 / 4.0)
        assert m == {0: 0, 1: 1, 2: 2}

    def test_degraded_platform_composes_events(self):
        mon = self._monitor()
        plat = Platform([Processor(f"p{i}", 100.0, 10.0)
                         for i in range(3)], 1.0,
                        link_bandwidth={(0, 1): 0.5, (1, 0): 0.5})
        degraded = mon.degraded_platform(plat, host_of_proc=lambda j: j)
        assert degraded.speed(2) == pytest.approx(100.0 * 1.1 / 4.0)
        assert degraded.speed(0) == 100.0
        # the old rebuild dropped link overrides; composition keeps them
        assert degraded.link_bandwidth == plat.link_bandwidth
        assert degraded.name.endswith("-degraded")

    def test_scenario_consumes_straggler_events(self):
        plat = default_cluster()
        wf = _wf("soykb", 120, 5, plat)
        cfg = SchedulerConfig(kprime=[2, 4])
        base = Scheduler(cfg).schedule(wf, plat)
        mon = StragglerMonitor(threshold=1.5)
        q = base.best.quotient
        slow = sorted({q.proc[v] for v in q.members})[0]
        for _ in range(8):
            for j in range(plat.k):
                mon.record(j, 3.0 if j == slow else 1.0)
        evs = mon.speed_events(plat, host_of_proc=lambda j: j,
                               at=0.3 * base.makespan)
        assert evs
        tl = run_scenario(Scenario(wf, plat, evs),
                          "pinned-warm-start", config=cfg)
        assert tl.feasible and tl.validate() == []


# ---------------------------------------------------------------------- #
# elastic rescale on the scenario API
# ---------------------------------------------------------------------- #
class TestRescalePlan:
    def _fleet(self, n_h100=48, n_degraded=16):
        from repro_torch.core.platform import h100_fleet_si
        return h100_fleet_si({"h100": n_h100, "h100-degraded": n_degraded})

    def test_infeasible_before_failure_is_structured(self):
        from repro_torch.configs import get_config, shape_by_name
        from repro_torch.runtime import rescale_plan
        cfg = get_config("jamba_15_large")  # 400B params, tiny fleet
        report = rescale_plan(cfg, shape_by_name("decode_32k"),
                              h100_fleet_si({"h100": 4}), failed={0},
                              kprime=[1, 2, 4])
        assert not report.feasible
        assert report.old_plan is None and report.new_plan is None
        assert report.infeasibility is not None
        assert report.timeline.segments == []

    def test_mid_trace_warm_start_rescale(self):
        from repro_torch.configs import get_config, shape_by_name
        from repro_torch.runtime import rescale_plan
        cfg = get_config("olmoe_1b_7b")
        plat = self._fleet()
        probe = rescale_plan(cfg, shape_by_name("decode_32k"), plat,
                             failed={0, 1, 2, 3},
                             kprime=[16, 32, 48, 64])
        assert probe.feasible
        report = rescale_plan(cfg, shape_by_name("decode_32k"), plat,
                              failed={0, 1, 2, 3},
                              at=0.5 * probe.est_step_before_s,
                              policy="pinned-warm-start",
                              kprime=[16, 32, 48, 64])
        assert report.feasible
        assert report.new_plan.valid
        assert report.timeline.makespan > 0
        assert report.new_plan.mapping.platform.k == plat.k - 4
        # mid-trace: the failure fired, so a migration was logged
        assert len(report.timeline.migrations) == 1


# ---------------------------------------------------------------------- #
# platform transforms: composition and reindexing (as
# tests/test_platform_transforms.py)
# ---------------------------------------------------------------------- #
def _platform(k=8):
    return Platform(
        [Processor(f"p{i}", float(2 + i), float(10 + 4 * i))
         for i in range(k)],
        bandwidth=1.0, name="prop",
        link_bandwidth={(0, 1): 0.5, (1, 0): 0.5, (2, 5): 3.0},
        failure_rates={0: 1e-3, 3: 5e-4, 5: 2e-3},
        power={1: ProcPower(0.5, 2.0), 5: ProcPower(1.0, 3.0, 2.5)},
    )


def _signature(plat: Platform):
    """Index-free fingerprint: processors by name + links by name pair
    + failure/power models by name."""
    procs = {p.name: (p.speed, p.memory) for p in plat.procs}
    links = {
        (plat.procs[a].name, plat.procs[b].name): bw
        for (a, b), bw in plat.link_bandwidth.items()
    }
    rates = {plat.procs[j].name: lam
             for j, lam in plat.failure_rates.items()}
    power = {plat.procs[j].name: pw.to_list()
             for j, pw in plat.power.items()}
    return procs, links, plat.bandwidth, rates, power


@st.composite
def _event_specs(draw):
    """Abstract event specs referencing processors by *original* name,
    so the same sequence can be lowered at different positions."""
    n_ops = draw(st.integers(min_value=1, max_value=6))
    ops = []
    fresh = 0
    for _ in range(n_ops):
        kind = draw(st.sampled_from(
            ["fail", "speed", "link", "arrive"]))
        if kind == "fail":
            ops.append(("fail", draw(st.integers(0, 7))))
        elif kind == "speed":
            ops.append(("speed", draw(st.integers(0, 7)),
                        draw(st.floats(0.1, 4.0))))
        elif kind == "link":
            a = draw(st.integers(0, 7))
            b = draw(st.integers(0, 7))
            if a == b:
                b = (b + 1) % 8
            ops.append(("link", a, b, draw(st.floats(0.05, 5.0)),
                        draw(st.booleans())))
        else:
            ops.append(("arrive", f"new{fresh}",
                        draw(st.floats(1.0, 8.0)),
                        draw(st.floats(8.0, 64.0))))
            fresh += 1
    return ops


def _apply(ops, plat):
    """Lower name-based specs onto ``plat``, tracking the index map."""
    name_to_idx = {p.name: j for j, p in enumerate(plat.procs)}
    cur = plat
    for op in ops:
        if op[0] == "fail":
            j = name_to_idx.get(f"p{op[1]}")
            if j is None or cur.k <= 1:
                continue  # already failed (idempotent spec)
            ev = ProcFailure(0.0, frozenset({j}))
        elif op[0] == "speed":
            j = name_to_idx.get(f"p{op[1]}")
            if j is None:
                continue  # speed change on a dead processor: no-op
            ev = SpeedChange(0.0, proc=j, factor=op[2])
        elif op[0] == "link":
            a = name_to_idx.get(f"p{op[1]}")
            b = name_to_idx.get(f"p{op[2]}")
            if a is None or b is None:
                continue  # link to a dead processor: no-op
            ev = LinkDegrade(0.0, src=a, dst=b, bandwidth=op[3],
                             symmetric=op[4])
        else:
            ev = ProcArrival(0.0, (Processor(op[1], op[2], op[3]),))
        cur, m = ev.apply(cur)
        name_to_idx = {
            name: m[j]
            for name, j in name_to_idx.items() if m[j] is not None
        }
        for j, p in enumerate(cur.procs):
            name_to_idx.setdefault(p.name, j)
    return cur


class TestTransformComposition:
    @given(ops=_event_specs())
    @settings(max_examples=60, deadline=None)
    def test_order_of_commuting_prefixes(self, ops):
        """Speed/link ops commute with each other and with failures of
        *other* processors: front-loading them before the failures
        yields the same signature as the drawn interleaving."""
        plat = _platform()
        mixed = _apply(ops, plat)
        fails = [op for op in ops if op[0] == "fail"]
        rest = [op for op in ops if op[0] != "fail"]
        front = _apply(rest + fails, plat)
        assert _signature(mixed) == _signature(front)

    @given(ops=_event_specs())
    @settings(max_examples=60, deadline=None)
    def test_proc_map_tracks_identity(self, ops):
        """Every surviving processor keeps its name/memory through any
        sequence, and the tracked index always points at it."""
        plat = _platform()
        cur = _apply(ops, plat)
        names = [p.name for p in cur.procs]
        assert len(names) == len(set(names))
        orig = {p.name: p for p in plat.procs}
        for p in cur.procs:
            if p.name in orig:
                assert p.memory == orig[p.name].memory

    @given(ops=_event_specs())
    @settings(max_examples=40, deadline=None)
    def test_links_never_dangle(self, ops):
        plat = _platform()
        cur = _apply(ops, plat)
        for (a, b) in cur.link_bandwidth:
            assert 0 <= a < cur.k and 0 <= b < cur.k

    def test_failure_reindexes_links_and_speed_composes(self):
        plat = _platform()
        # degrade link p2<->p5, slow p5, then fail p0..p1: the link and
        # the slowdown must follow p2/p5 to their compacted indices
        cur, m1 = LinkDegrade(0.0, src=2, dst=5,
                              bandwidth=0.25).apply(plat)
        cur, m2 = SpeedChange(0.0, proc=5, factor=0.5).apply(cur)
        cur, m3 = ProcFailure(0.0, frozenset({0, 1})).apply(cur)
        j2, j5 = m3[m2[m1[2]]], m3[m2[m1[5]]]
        assert cur.procs[j2].name == "p2" and cur.procs[j5].name == "p5"
        assert cur.bandwidth_between(j2, j5) == 0.25
        assert cur.bandwidth_between(j5, j2) == 0.25
        assert cur.speed(j5) == pytest.approx(plat.speed(5) * 0.5)
        # and the same end state when the failure comes first
        alt, n1 = ProcFailure(0.0, frozenset({0, 1})).apply(plat)
        alt, n2 = LinkDegrade(0.0, src=n1[2], dst=n1[5],
                              bandwidth=0.25).apply(alt)
        alt, _ = SpeedChange(0.0, proc=n2[n1[5]], factor=0.5).apply(alt)
        assert _signature(alt) == _signature(cur)


class TestModelCarrying:
    """``failure_rates`` / ``power`` ride the elastic transforms exactly
    like ``link_bandwidth``: preserved by index-stable transforms,
    reindexed by ``without``, dropped with their processor."""

    def test_without_with_speed_with_processors_compose(self):
        plat = _platform()
        cur = plat.with_processors([Processor("new0", 3.0, 32.0)])
        cur = cur.with_speed(5, 0.5)
        cur = cur.without({0, 1})
        # p0's failure rate died with p0; p3/p5's followed the reindex
        rates = {cur.procs[j].name: lam
                 for j, lam in cur.failure_rates.items()}
        assert rates == {"p3": 5e-4, "p5": 2e-3}
        power = {cur.procs[j].name: pw
                 for j, pw in cur.power.items()}
        assert power == {"p5": ProcPower(1.0, 3.0, 2.5)}
        # the speed change neither moved nor scaled the models
        idx = {p.name: j for j, p in enumerate(cur.procs)}
        assert cur.failure_rate(idx["p3"]) == 5e-4
        assert cur.proc_power(idx["p5"]).busy_watts(1.0) == 4.0

    def test_order_independence_direct(self):
        plat = _platform()
        a = plat.with_processors([Processor("x", 1.0, 16.0)]) \
                .with_speed(2, 2.0).without({4})
        b = plat.without({4}).with_speed(2, 2.0) \
                .with_processors([Processor("x", 1.0, 16.0)])
        assert _signature(a) == _signature(b)

    @given(failed=st.sets(st.integers(0, 7), min_size=1, max_size=6))
    @settings(max_examples=40, deadline=None)
    def test_without_reindexes_models(self, failed):
        plat = _platform()
        cur = plat.without(failed)
        surviving = {p.name for p in cur.procs}
        want_rates = {plat.procs[j].name: lam
                      for j, lam in plat.failure_rates.items()
                      if plat.procs[j].name in surviving}
        got_rates = {cur.procs[j].name: lam
                     for j, lam in cur.failure_rates.items()}
        assert got_rates == want_rates
        want_power = {plat.procs[j].name: pw
                      for j, pw in plat.power.items()
                      if plat.procs[j].name in surviving}
        got_power = {cur.procs[j].name: pw
                     for j, pw in cur.power.items()}
        assert got_power == want_power

    def test_with_merge_semantics(self):
        plat = _platform()
        p2 = plat.with_failure_rates({1: 9e-9})
        assert p2.failure_rates == {0: 1e-3, 1: 9e-9, 3: 5e-4, 5: 2e-3}
        p3 = plat.with_failure_rates({1: 9e-9}, merge=False)
        assert p3.failure_rates == {1: 9e-9}
        with pytest.raises(ValueError):
            plat.with_failure_rates({99: 1e-3})
        with pytest.raises(ValueError):
            plat.with_failure_rates({0: -1.0})
        with pytest.raises(TypeError):
            plat.with_power({0: "not a ProcPower"})


# ---------------------------------------------------------------------- #
# parity with repro.scenario and repro.runtime.rescale_plan
# ---------------------------------------------------------------------- #
import repro.core as J  # noqa: E402
import repro.scenario as J_scenario  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.scenario as T_scenario  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shape_by_name as j_shape_by_name  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.runtime import rescale_plan as j_rescale_plan  # noqa: E402
from repro.runtime.fault import StragglerMonitor as JStragglerMonitor  # noqa: E402
from repro_torch.configs import get_config, shape_by_name  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.runtime import rescale_plan  # noqa: E402

POLICIES = ("pinned-warm-start", "full-replan", "no-replan")


@pytest.fixture
def parity_setting():
    """montage n=200 on the default cluster in each package, its plan, the
    processors the plan uses and an event time 40 % into it.  Made anew in
    each test, after ``fresh_metrics``: the plan's metrics and cache stats
    list their keys in the order the registry first saw them."""
    cfg = dict(kprime=KPRIME, simulate=True)
    sides = {}
    for side, core in (("port", T), ("jax", J)):
        plat = core.default_cluster()
        wf = core.generate_workflow("montage", 200, seed=1, platform=plat)
        sides[side] = (plat, wf, core.Scheduler(core.SchedulerConfig(**cfg)).schedule(wf, plat))
    q = sides["port"][2].best.quotient
    used = sorted({q.proc[v] for v in q.members})
    return sides, cfg, used, 0.4 * sides["port"][2].makespan


def _events(kind, used, te):
    """The port's events of one kind at ``te`` ("tie": three at once, in
    the canonical order; "chain": a failure, then an arrival)."""
    if kind == "proc_failure":
        return [ProcFailure(te, frozenset(used[:2]))]
    if kind == "proc_arrival":
        return [ProcArrival(te, procs=(Processor("fresh-0", 64.0, 256.0),))]
    if kind == "speed_change":
        return [SpeedChange(te, proc=used[0], factor=0.25)]
    if kind == "link_degrade":
        return [LinkDegrade(te, src=used[0], dst=used[1], bandwidth=0.05)]
    if kind == "tie":
        return [ProcFailure(te, frozenset({used[-1]})),
                SpeedChange(te, proc=used[0], factor=0.5),
                LinkDegrade(te, src=used[0], dst=used[1], bandwidth=0.1, symmetric=False)]
    return [ProcFailure(te, frozenset({used[0]})),
            ProcArrival(1.5 * te, procs=(Processor("fresh-0", 64.0, 256.0),))]


def _both_timelines(parity_setting, events, policy, **kw):
    """The port's ``events`` through the port's ``run_scenario``, and the
    same events rebuilt as JAX's through JAX's."""
    sides, cfg, _, _ = parity_setting
    out = []
    for side, core, scenario, evs in (("port", T, T_scenario, events),
                                      ("jax", J, J_scenario, events_as(events, "jax"))):
        plat, wf, base = sides[side]
        out.append(scenario.run_scenario(scenario.Scenario(wf, plat, evs), policy,
                                         config=core.SchedulerConfig(**cfg),
                                         initial_report=base, **kw))
    return out


class TestParity:
    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("kind", ["proc_failure", "proc_arrival", "speed_change",
                                      "link_degrade", "tie", "chain"])
    def test_timeline_json_equal(self, parity_setting, kind, policy):
        _, _, used, te = parity_setting
        ours, ref = _both_timelines(parity_setting, _events(kind, used, te), policy)
        assert untimed_timeline_json(ours) == untimed_timeline_json(ref)
        assert ours.gantt(width=64) == ref.gantt(width=64)
        assert (ours.feasible, ours.makespan) == (ref.feasible, ref.makespan)
        if ours.feasible:
            assert ours.validate() == []

    @pytest.mark.parametrize("price_migration", [False, True])
    def test_timeline_json_equal_with_checkpoint_pricing(self, parity_setting,
                                                         price_migration):
        _, _, used, te = parity_setting
        ours, ref = _both_timelines(parity_setting, [ProcFailure(te, frozenset({used[-1]}))],
                                    "pinned-warm-start", price_migration=price_migration)
        assert untimed_timeline_json(ours) == untimed_timeline_json(ref)
        assert ours.migrations[0].checkpoint_decisions

    def test_straggler_events_drive_equal_timelines(self):
        """The port's monitor emits the port's ``SpeedChange`` events,
        which drive the port's ``run_scenario`` to JAX's timeline."""
        out = []
        for core, scenario_mod, monitor in ((T, T_scenario, StragglerMonitor),
                                            (J, J_scenario, JStragglerMonitor)):
            plat = core.default_cluster()
            wf = core.generate_workflow("soykb", 120, seed=5, platform=plat)
            cfg = core.SchedulerConfig(kprime=[2, 4])
            base = core.Scheduler(cfg).schedule(wf, plat)
            q = base.best.quotient
            slow = sorted({q.proc[v] for v in q.members})[:2]
            mon = monitor(threshold=1.5)
            for step in range(8):
                for j in range(plat.k):
                    mon.record(j, (3.0 + 0.1 * step) if j in slow else 1.0 + 0.01 * j)
            evs = mon.speed_events(plat, host_of_proc=lambda j: j, at=0.3 * base.makespan)
            assert len(evs) == 2 and all(isinstance(e, scenario_mod.SpeedChange) for e in evs)
            tl = scenario_mod.run_scenario(scenario_mod.Scenario(wf, plat, evs),
                                           "pinned-warm-start", config=cfg)
            out.append(([e.to_dict() for e in evs], untimed_timeline_json(tl)))
        assert out[0] == out[1]


PREFILL = (2, 4096)   # chip_smoke.py phase 29's shape: B=2 x S=4096


def _prefill(shape_cls):
    b, s = PREFILL
    return shape_cls("prefill", seq_len=s, global_batch=b, kind="prefill")


def _stage_of_task(p):
    return None if p is None else p.stage_of_task


@pytest.mark.parametrize("case,arch,shape,spec,failed,at,policy,kprime", [
    ("mixtral-3-lose-0", "mixtral_8x7b", "prefill", {"h100": 3}, {0}, 0.0,
     "full-replan", "auto"),
    ("mixtral-3-lose-1-2", "mixtral_8x7b", "prefill", {"h100": 3}, {1, 2}, 0.0,
     "full-replan", "auto"),
    ("mixtral-3-lose-0-mid-step", "mixtral_8x7b", "prefill", {"h100": 3}, {0}, 0.5,
     "pinned-warm-start", "auto"),
    ("llama-2-lose-0", "llama3_8b", "prefill", {"h100": 2}, {0}, 0.0, "full-replan", "auto"),
    ("mixtral-64-lose-8-mid-step", "mixtral_8x7b", "decode_32k",
     {"h100": 56, "h100-degraded": 8}, set(range(8)), 0.5, "pinned-warm-start",
     [8, 16, 32, 56]),
])
def test_rescale_plan_equal_on_h100_fleets(case, arch, shape, spec, failed, at, policy,
                                           kprime):
    """``rescale_plan`` of chip_smoke.py phase 30 (b) and of
    ``examples/elastic_serving_torch.py`` against JAX's on the same
    processors (``at`` is a fraction of the healthy step)."""
    fleet = h100_fleet_si(spec)
    ours_shape = _prefill(ShapeConfig) if shape == "prefill" else shape_by_name(shape)
    ref_shape = _prefill(JShapeConfig) if shape == "prefill" else j_shape_by_name(shape)
    healthy = rescale_plan(get_config(arch), ours_shape, fleet, failed, kprime=kprime)
    t = at * healthy.est_step_before_s
    ours = rescale_plan(get_config(arch), ours_shape, fleet, failed, at=t, policy=policy,
                        kprime=kprime)
    ref = j_rescale_plan(j_get_config(arch), ref_shape, platform_as(fleet, "jax"), failed,
                         at=t, policy=policy, kprime=kprime)
    assert (ours.feasible, ours.est_step_before_s, ours.est_step_after_s, ours.moved_tasks) == (
        ref.feasible, ref.est_step_before_s, ref.est_step_after_s, ref.moved_tasks)
    assert (ours.infeasibility and ours.infeasibility.to_dict()) == (
        ref.infeasibility and ref.infeasibility.to_dict())
    assert _stage_of_task(ours.old_plan) == _stage_of_task(ref.old_plan)
    assert _stage_of_task(ours.new_plan) == _stage_of_task(ref.new_plan)
    assert untimed_timeline_json(ours.timeline) == untimed_timeline_json(ref.timeline)
    assert ours.old_plan is not None
    if case == "mixtral-3-lose-1-2":
        assert not ours.feasible and ours.infeasibility.stage == "merge"
    else:
        assert ours.feasible and ours.new_plan.valid
    if at:
        assert len(ours.timeline.migrations) == 1
