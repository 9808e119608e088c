"""The port's objectives, ``repro_torch.objectives``, and its objective
stages.

Every case of ``tests/test_objectives.py`` on the port alone: the
accounting identities (energy decomposition, reliability bounds and
monotonicity), bit-inertness of the objective stages on model-free
platforms, the structured infeasibility of an unreachable reliability
floor, the sim-side energy integrals, and the checkpoint-pricing decisions
in the replan path.

Then parity with ``repro.objectives`` on the paper's cluster presets with
failure and power models, each package on its own objects:
``schedule_reliability``, ``schedule_energy``, ``energy_plan``,
``energy_from_sim``, ``plan_reliability`` and ``plan_energy`` equal under
``==`` (reports through ``to_dict``).
"""
import math

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # pragma: no cover
    from _hypothesis_fallback import given, settings, st

from repro_torch.core import (
    Platform,
    ProcPower,
    Processor,
    Scheduler,
    SchedulerConfig,
    default_cluster,
    generate_workflow,
)
from repro_torch.objectives import (
    EnergyReport,
    ReliabilityReport,
    block_exposures,
    energy_from_sim,
    energy_plan,
    plan_energy,
    plan_reliability,
    schedule_energy,
    schedule_reliability,
)
from repro_torch.sim import simulate

from _torch_parity import fresh_metrics, untimed_schedule_json  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def platform():
    return default_cluster()


@pytest.fixture(scope="module")
def wf(platform):
    return generate_workflow("genome", 120, seed=3, platform=platform)


@pytest.fixture(scope="module")
def mapping(wf, platform):
    rep = Scheduler(SchedulerConfig()).schedule(wf, platform)
    assert rep.feasible
    return rep.best


def _modeled(platform, rng_rates=None, power_kw=None):
    k = platform.k
    # calibrated so the nominal schedule's success prob ≈ 0.96 on the
    # module fixture — floors of 0.9/0.95 are reachable, 0.999999 not
    rates = rng_rates or {j: 5e-7 * (j + 1) for j in range(k)}
    power = power_kw or {j: ProcPower(0.5 + 0.1 * j, 2.0) for j in range(k)}
    return platform.with_failure_rates(rates).with_power(power)


# ---------------------------------------------------------------------- #
# reliability accounting
# ---------------------------------------------------------------------- #
class TestReliability:
    def test_no_model_is_trivial(self, mapping, platform):
        rel = schedule_reliability(mapping, platform)
        assert rel.success_prob == 1.0
        assert rel.weighted_makespan == rel.makespan

    @given(scale=st.floats(1e-6, 1e-2))
    @settings(max_examples=20, deadline=None)
    def test_bounds_and_monotonicity(self, mapping, platform, scale):
        """success_prob ∈ (0, 1], and scaling every failure rate up
        (more exposure-weighted hazard) never increases it."""
        k = platform.k
        p1 = platform.with_failure_rates(
            {j: scale for j in range(k)})
        p2 = platform.with_failure_rates(
            {j: 2 * scale for j in range(k)})
        r1 = schedule_reliability(mapping, p1)
        r2 = schedule_reliability(mapping, p2)
        for r in (r1, r2):
            assert 0.0 < r.success_prob <= 1.0
            assert r.weighted_makespan >= r.makespan
        assert r2.success_prob <= r1.success_prob

    def test_monotone_in_exposure(self, mapping, platform):
        """Slowing blocks down (longer exposure at the same rates)
        never increases the success probability."""
        pf = platform.with_failure_rates(
            {j: 1e-4 for j in range(platform.k)})
        fast = schedule_reliability(mapping, pf)
        slow = schedule_reliability(
            mapping, pf,
            speed_scale={v: 0.5 for v in mapping.quotient.members})
        assert slow.success_prob <= fast.success_prob
        exp_fast = block_exposures(mapping, pf)
        exp_slow = block_exposures(
            mapping, pf,
            {v: 0.5 for v in mapping.quotient.members})
        for v in exp_fast:
            assert exp_slow[v] == pytest.approx(2 * exp_fast[v])

    def test_closed_form(self, mapping, platform):
        pf = platform.with_failure_rates({0: 3e-4, 2: 7e-4})
        rel = schedule_reliability(mapping, pf)
        q = mapping.quotient
        hazard = sum(pf.failure_rate(q.proc[v]) * dur
                     for v, dur in rel.exposure.items())
        assert rel.success_prob == pytest.approx(math.exp(-hazard))
        assert rel.hazard == pytest.approx(
            sum(rel.proc_hazard.values()))

    def test_json_roundtrip(self, mapping, platform):
        rel = schedule_reliability(mapping, _modeled(platform))
        assert ReliabilityReport.from_dict(rel.to_dict()) == rel


# ---------------------------------------------------------------------- #
# energy accounting
# ---------------------------------------------------------------------- #
class TestEnergy:
    @given(static=st.floats(0.0, 5.0), dyn=st.floats(0.1, 5.0),
           alpha=st.floats(1.0, 3.0))
    @settings(max_examples=20, deadline=None)
    def test_decomposition_identity(self, mapping, platform,
                                    static, dyn, alpha):
        """energy(plan) == Σ per-block dynamic + Σ per-proc static."""
        pw = platform.with_power(
            {j: ProcPower(static, dyn, alpha) for j in range(platform.k)})
        e = schedule_energy(mapping, pw)
        assert e.total == pytest.approx(
            sum(e.per_block_dynamic.values())
            + sum(e.per_proc_static.values()), rel=1e-12)
        assert e.dynamic == pytest.approx(
            sum(e.per_block_dynamic.values()), rel=1e-12)
        assert e.static == pytest.approx(
            sum(e.per_proc_static.values()), rel=1e-12)

    def test_block_dynamic_closed_form(self, mapping, platform):
        pw = platform.with_power(
            {j: ProcPower(0.0, 3.0, 2.0) for j in range(platform.k)})
        e = schedule_energy(mapping, pw)
        q = mapping.quotient
        for v, ev in e.per_block_dynamic.items():
            s = platform.procs[q.proc[v]].speed
            assert ev == pytest.approx(3.0 * q.weight[v] * s)  # (α-1)=1

    def test_dvfs_scaling_saves_dynamic_energy(self, mapping, platform):
        pw = platform.with_power(
            {j: ProcPower(0.0, 2.0, 2.0) for j in range(platform.k)})
        nominal = schedule_energy(mapping, pw)
        half = schedule_energy(
            mapping, pw,
            speed_of_block={v: 0.5 for v in mapping.quotient.members})
        assert half.dynamic == pytest.approx(0.5 * nominal.dynamic)
        assert half.horizon == pytest.approx(2 * nominal.horizon)

    def test_json_roundtrip(self, mapping, platform):
        e = schedule_energy(mapping, _modeled(platform),
                            reliability_floor=0.9)
        assert EnergyReport.from_dict(e.to_dict()) == e


class TestEnergyPlan:
    def test_floor_met_or_none(self, mapping, platform):
        pf = _modeled(platform)
        plan = energy_plan(mapping, pf, reliability_floor=0.95,
                           speed_levels=(0.5, 0.75, 1.0))
        assert plan is not None
        assert plan.reliability >= 0.95
        # greedy only raises speeds above the all-lowest start
        assert all(0.5 <= f <= 1.0 for f in plan.speed_of_block.values())

    def test_unconstrained_runs_lowest_level(self, mapping, platform):
        pf = _modeled(platform)
        plan = energy_plan(mapping, pf, speed_levels=(0.25, 1.0))
        assert set(plan.speed_of_block.values()) == {0.25}

    def test_unreachable_floor_is_none(self, mapping, platform):
        hot = platform.with_failure_rates(
            {j: 0.5 for j in range(platform.k)}).with_power(
            {j: ProcPower(1.0, 1.0) for j in range(platform.k)})
        assert energy_plan(mapping, hot,
                           reliability_floor=0.999999) is None

    def test_bad_levels_rejected(self, mapping, platform):
        with pytest.raises(ValueError):
            energy_plan(mapping, _modeled(platform),
                        speed_levels=(0.0,))
        with pytest.raises(ValueError):
            energy_plan(mapping, _modeled(platform),
                        speed_levels=(1.5,))


# ---------------------------------------------------------------------- #
# sim-side accounting (per-proc busy integrals)
# ---------------------------------------------------------------------- #
class TestSimEnergy:
    def test_attached_when_modeled(self, mapping, platform):
        pf = _modeled(platform)
        sim = simulate(mapping, pf)
        assert sim.energy is not None
        acc = energy_from_sim(sim, pf)
        assert sim.energy == acc
        assert acc["total"] == pytest.approx(
            sum(acc["dynamic"].values()) + sum(acc["static"].values()),
            rel=1e-12)
        assert 0 < acc["success_prob"] <= 1

    def test_absent_without_model(self, mapping, platform):
        assert simulate(mapping, platform).energy is None

    def test_matches_analytic_at_nominal(self, mapping, platform):
        """Deterministic replay: per-proc busy integrals equal the sum
        of block durations, so sim dynamic energy == analytic dynamic
        energy (statics differ only via horizon vs makespan)."""
        pf = _modeled(platform)
        sim = simulate(mapping, pf)
        analytic = schedule_energy(mapping, pf)
        assert sum(sim.energy["dynamic"].values()) == pytest.approx(
            analytic.dynamic, rel=1e-9)
        hazard_sim = sim.energy["hazard"]
        rel = schedule_reliability(mapping, pf)
        assert hazard_sim == pytest.approx(rel.hazard, rel=1e-9)

    def test_json_roundtrip(self, mapping, platform):
        from repro_torch.sim import SimReport

        sim = simulate(mapping, _modeled(platform))
        assert SimReport.from_json(sim.to_json()).energy == sim.energy


# ---------------------------------------------------------------------- #
# objective stages: registration, sweep, inertness, infeasibility
# ---------------------------------------------------------------------- #
class TestObjectiveStages:
    def test_registered_pipelines(self):
        from repro_torch.core.scheduler import PIPELINES

        assert PIPELINES["reliability"][-1] == "reliability"
        assert PIPELINES["energy"][-1] == "energy"

    def test_bit_inert_without_models(self, wf, platform):
        base = Scheduler(SchedulerConfig()).schedule(wf, platform)
        for algo in ("reliability", "energy"):
            rep = Scheduler(SchedulerConfig(),
                            algorithm=algo).schedule(wf, platform)
            assert rep.makespan == base.makespan
            assert rep.best.extras.get(algo) is None
            assert [p.makespan for p in rep.sweep] == \
                [p.makespan for p in base.sweep]

    def test_reliability_reported_on_schedule_report(self, wf, platform):
        pf = _modeled(platform)
        rep = Scheduler(SchedulerConfig(),
                        algorithm="reliability").schedule(wf, pf)
        assert rep.feasible
        assert rep.reliability is not None
        assert 0 < rep.reliability.success_prob <= 1

    def test_parallel_sweep_matches_serial(self, wf, platform):
        pf = _modeled(platform)
        serial = plan_reliability(wf, pf, workers=1)
        par = plan_reliability(wf, pf, workers=2)
        assert serial.reliability.weighted_makespan == pytest.approx(
            par.reliability.weighted_makespan)
        assert serial.k_prime == par.k_prime

    def test_plan_reliability_picks_weighted_winner(self, wf, platform):
        pf = _modeled(platform)
        res = plan_reliability(wf, pf)
        assert res.feasible
        best_w = res.reliability.weighted_makespan
        for p in res.report.sweep:
            if not p.feasible:
                continue
            h = p.metrics.get("histograms", {}).get(
                "objective_rel_weighted_ms")
            if h and h.get("count"):
                assert best_w <= h["sum"] + 1e-9

    def test_plan_energy_floor_and_infeasibility(self, wf, platform):
        pf = _modeled(platform)
        ok = plan_energy(wf, pf, reliability_floor=0.9,
                         speed_levels=(0.5, 1.0))
        assert ok.feasible and ok.energy.reliability >= 0.9
        hot = platform.with_failure_rates(
            {j: 0.5 for j in range(platform.k)}).with_power(
            {j: ProcPower(1.0, 1.0) for j in range(platform.k)})
        bad = plan_energy(wf, hot, reliability_floor=0.999999)
        assert not bad.feasible
        assert bad.report.infeasibility is not None
        assert bad.report.infeasibility.stage == "objective"

    def test_objective_metrics_observed(self, wf, platform):
        pf = _modeled(platform)
        rep = Scheduler(SchedulerConfig(),
                        algorithm="energy").schedule(wf, pf)
        hists = rep.metrics.get("histograms", {})
        assert "objective_energy_total" in hists
        assert "objective_success_prob" in hists


# ---------------------------------------------------------------------- #
# checkpoint-cost-aware migration pricing
# ---------------------------------------------------------------------- #
class TestCheckpointPricing:
    def _timeline(self, price_migration):
        from repro_torch.scenario import ProcFailure, Scenario, run_scenario

        plat = default_cluster()
        w = generate_workflow("genome", 150, seed=5, platform=plat)
        sc = Scenario(w, plat, [ProcFailure(time=30.0, procs={0})])
        return run_scenario(sc, policy="pinned-warm-start",
                            config=SchedulerConfig(simulate=True),
                            price_migration=price_migration), w

    def test_decisions_in_migration_log(self):
        tl, _ = self._timeline(False)
        assert tl.feasible
        assert tl.migrations, "failure must trigger a replan"
        decs = [d for m in tl.migrations for d in m.checkpoint_decisions]
        for d in decs:
            assert d["decision"] in ("restart-in-place", "migrate")
            assert d["restart_cost"] > 0
            assert d["inputs_volume"] >= 0
            assert not d["applied"]  # advisory without price_migration
        # round-trips with the rest of the record
        from repro_torch.scenario import MigrationRecord

        for m in tl.migrations:
            rt = MigrationRecord.from_dict(m.to_dict())
            assert rt.checkpoint_decisions == m.checkpoint_decisions

    def test_price_migration_unpins_winners(self):
        tl, w = self._timeline(True)
        assert tl.feasible
        decs = [d for m in tl.migrations for d in m.checkpoint_decisions]
        for d in decs:
            assert d["applied"] == (d["decision"] == "migrate")
        # invariants still hold with pricing applied
        assert tl.validate(memory_trace=True) == []
        last = tl.segments[-1]
        assert last.completed_before + last.n_tasks == w.n

    def test_pricing_prefers_restart_on_uniform_platform(self):
        """With equal speeds, migrating can never beat restarting in
        place (same compute cost + a transfer)."""
        from repro_torch.scenario import ProcFailure, Scenario, run_scenario

        plat = Platform([Processor(f"u{j}", 1.0, 256.0)
                         for j in range(4)], bandwidth=1.0, name="uni")
        w = generate_workflow("genome", 100, seed=9, platform=plat)
        sc = Scenario(w, plat, [ProcFailure(time=20.0, procs={0})])
        tl = run_scenario(sc, policy="pinned-warm-start",
                          config=SchedulerConfig(simulate=True))
        for m in tl.migrations:
            for d in m.checkpoint_decisions:
                assert d["decision"] == "restart-in-place"


# ---------------------------------------------------------------------- #
# parity with repro.objectives on the paper's presets
# ---------------------------------------------------------------------- #
import repro.core as J  # noqa: E402
import repro.objectives as J_obj  # noqa: E402
import repro.sim as J_sim  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.objectives as T_obj  # noqa: E402
import repro_torch.sim as T_sim  # noqa: E402

#: each package's core, objectives and simulator
SIDES = ((T, T_obj, T_sim), (J, J_obj, J_sim))
PRESETS = ("default_cluster", "small_cluster", "large_cluster", "more_het_cluster",
           "less_het_cluster", "no_het_cluster")


def _modeled_preset(core, preset, hot=False):
    """A paper preset with a failure model on every other processor and a
    power model on all of them (``hot``: rates high enough that a tight
    floor is out of reach)."""
    plat = getattr(core, preset)()
    rates = {j: (0.5 if hot else 4e-7 * (j + 1)) for j in range(0, plat.k, 2 - hot)}
    power = {j: core.ProcPower(0.4 + 0.05 * j, 1.5 + 0.1 * (j % 3), 2.0 + 0.5 * (j % 2))
             for j in range(plat.k)}
    return plat.with_failure_rates(rates).with_power(power)


def _per_side(preset, family="montage", n=150, hot=False):
    """Each side's modeled preset, workflow and scheduled mapping."""
    out = []
    for core, obj, sim in SIDES:
        plat = _modeled_preset(core, preset, hot)
        wf = core.generate_workflow(family, n, seed=4, platform=getattr(core, preset)())
        rep = core.schedule(wf, plat, kprime=[2, 5, 9])
        assert rep.feasible
        out.append((core, obj, sim, plat, wf, rep))
    return out


@pytest.mark.parametrize("preset", PRESETS)
def test_accounting_equal_on_the_paper_presets(preset):
    records = []
    for core, obj, sim, plat, wf, rep in _per_side(preset):
        res = rep.best
        scale = {v: (0.5 if v % 2 else 0.8) for v in res.quotient.members}
        sr = sim.simulate(res, comm="fair-share")
        records.append({
            "reliability": obj.schedule_reliability(res).to_dict(),
            "reliability_scaled": obj.schedule_reliability(
                res, speed_scale=scale, makespan=2.0 * res.makespan).to_dict(),
            "energy": obj.schedule_energy(res).to_dict(),
            "energy_scaled": obj.schedule_energy(res, speed_of_block=scale,
                                                 reliability_floor=0.9).to_dict(),
            "plan": [None if (e := obj.energy_plan(res, reliability_floor=floor,
                                                   speed_levels=levels)) is None
                     else e.to_dict()
                     for floor in (None, 0.9, 0.99, 0.999999)
                     for levels in ((1.0,), (0.5, 0.75, 1.0))],
            "exposures": obj.block_exposures(res, plat, scale),
            "sim_energy": obj.energy_from_sim(sr, plat),
            "sim_attached": sr.energy,
            "sim_json": sr.to_json(),
        })
    assert records[0] == records[1]
    assert records[0]["sim_attached"] == records[0]["sim_energy"]
    assert any(p is not None for p in records[0]["plan"])


@pytest.mark.parametrize("preset", ["default_cluster", "more_het_cluster"])
def test_plans_equal(preset):
    records = []
    for core, obj, sim, plat, wf, rep in _per_side(preset, family="genome", n=120):
        rel = obj.plan_reliability(wf, plat, kprime=[1, 3, 6, 10])
        en = obj.plan_energy(wf, plat, reliability_floor=0.95, speed_levels=(0.5, 1.0),
                             kprime=[1, 3, 6, 10])
        records.append({
            "rel": (rel.k_prime, rel.reliability.to_dict(), untimed_schedule_json(rel.report)),
            "energy": (en.k_prime, en.energy.to_dict(), untimed_schedule_json(en.report)),
        })
    assert records[0] == records[1]


def test_unreachable_floor_equal():
    records = []
    for core, obj, sim, plat, wf, rep in _per_side("small_cluster", n=80, hot=True):
        bad = obj.plan_energy(wf, plat, reliability_floor=0.999999, kprime=[2, 4])
        records.append((bad.feasible, bad.report.infeasibility.to_dict(),
                        untimed_schedule_json(bad.report)))
    assert records[0] == records[1]
    assert not records[0][0] and records[0][1]["stage"] == "objective"
