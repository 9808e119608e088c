"""The port's steady-state throughput analysis, ``repro_torch.throughput``,
with the sustained admission of ``repro_torch.service``.

Every case of ``tests/test_throughput.py`` on the port alone.  The
load-bearing anchor: one instance arriving at rate→0 reproduces
``schedule(wf, platform, simulate=True)`` bit-exactly on all seven n=1000
families.  Around it: the engine's release floor, seeded arrival
processes, dominance-matched replication, the N-instance sandwich
property, the summed memory-occupancy tracker, the scheduler's
``throughput`` pipeline, sustained admission through the plan cache and
the per-instance trace tooling.

Then parity with ``repro.throughput`` on the same seeded inputs, each
package on its own objects: arrival instants, ``replicate_plan`` and
``build_pipelined_specs`` under ``==``, ``ThroughputPlan`` and
``PipelinedReport`` through their dicts (JSON byte for byte), the
``throughput`` pipeline's ``ScheduleReport`` byte for byte (timing set
aside) at ``workers`` 1 and 2, ``plan_throughput`` on the seven families,
``saturation_sweep``'s rows, and ``run_sustained`` cold then seeded through
``untimed_service_json``.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep absent: seeded-random fallback
    from _hypothesis_fallback import given, settings, st

import repro.core as J
import repro.service as J_service
import repro.throughput as J_tp
from repro.core.baseline import MappingResult as JMappingResult
from repro.core.dag import build_quotient as j_build_quotient
from repro_torch.core import (
    FAMILIES,
    Platform,
    Processor,
    Workflow,
    default_cluster,
    generate_workflow,
    makespan,
    schedule,
)
from repro_torch.core.dag import build_quotient
from repro_torch.sim import BlockSpec, ContentionFreeComm, EdgeSpec, run_engine
from repro_torch.service import PlanCache, run_sustained
from repro_torch.throughput import (
    ArrivalSpec,
    PipelinedReport,
    ThroughputPlan,
    build_pipelined_specs,
    plan_throughput,
    proc_busy_times,
    replicate_plan,
    saturation_sweep,
    simulate_pipelined,
)
from repro_torch.throughput.pipeline import _pipelined_memory_trace

from _torch_parity import (  # noqa: F401 (fixture)
    fresh_metrics,
    joined_pools,
    untimed_schedule_json,
    untimed_service_json,
)


def make_random_dag(n: int, seed: int, p: float = 0.3, core=None) -> Workflow:
    """``tests/conftest.py``'s random DAG, as ``core``'s ``Workflow`` (the
    port's by default)."""
    rng = np.random.default_rng(seed)
    wf = (core.Workflow if core is not None else Workflow)(n)
    for u in range(n):
        wf.work[u] = float(rng.uniform(1, 100))
        wf.mem[u] = float(rng.uniform(1, 50))
    for u in range(n):
        for v in range(u + 1, n):
            if rng.random() < p:
                wf.add_edge(u, v, float(rng.uniform(1, 10)))
    return wf


ANCHOR_N = 1000


@pytest.fixture(scope="module")
def plat() -> Platform:
    return default_cluster()


@pytest.fixture(scope="module")
def family_wfs(plat):
    """The seven n=1000 instances, generated once per module."""
    return {f: generate_workflow(f, ANCHOR_N, seed=1, platform=plat)
            for f in FAMILIES}


def unit_procs(k: int, mem: float = 1e9) -> Platform:
    return Platform([Processor(f"p{i}", 1.0, mem) for i in range(k)], 1.0)


def chain_workflow(n: int = 3) -> Workflow:
    wf = Workflow(n)
    wf.work[:] = [2.0] * n
    wf.mem[:] = [1.0] * n
    for u in range(n - 1):
        wf.add_edge(u, u + 1, 1.0)
    return wf


def singleton_mapping(wf: Workflow, platform: Platform):
    """Every task its own block on its own processor (round-robin)."""
    q = build_quotient(wf, list(range(wf.n)))
    for i, vid in enumerate(sorted(q.members)):
        q.proc[vid] = i % platform.k
    return q


# ---------------------------------------------------------------------- #
# engine release floor
# ---------------------------------------------------------------------- #
class TestEngineRelease:
    def test_release_floors_start(self):
        blocks = [BlockSpec(0, 0, 1.0)]
        tr = run_engine(blocks, [], ContentionFreeComm(), unit_procs(1),
                        release={0: 5.0})
        assert tr.start[0] == 5.0
        assert tr.finish[0] == 6.0

    def test_release_does_not_delay_late_readiness(self):
        # pred finishes at 2.0 > release 1.0: release floor is inert
        blocks = [BlockSpec(0, 0, 2.0), BlockSpec(1, 1, 1.0)]
        edges = [EdgeSpec(0, 1, 0.0)]
        tr = run_engine(blocks, edges, ContentionFreeComm(),
                        unit_procs(2), release={1: 1.0})
        assert tr.start[1] == 2.0

    def test_empty_release_bit_identical(self):
        wf = chain_workflow(4)
        plat = unit_procs(4)
        q = singleton_mapping(wf, plat)
        from repro_torch.sim import build_specs

        blocks, edges = build_specs(q, plat)
        a = run_engine(blocks, edges, ContentionFreeComm(), plat)
        b = run_engine(blocks, edges, ContentionFreeComm(), plat,
                       release={})
        assert a.start == b.start and a.finish == b.finish
        assert a.horizon == b.horizon


# ---------------------------------------------------------------------- #
# arrival processes
# ---------------------------------------------------------------------- #
class TestArrivals:
    def test_deterministic_kind(self):
        t = ArrivalSpec(0.5, "deterministic", start=3.0).times(4)
        assert list(t) == [3.0, 5.0, 7.0, 9.0]

    def test_poisson_seeded_and_monotone(self):
        spec = ArrivalSpec(2.0, "poisson")
        a = spec.times(64, seed=7)
        b = spec.times(64, seed=7)
        c = spec.times(64, seed=8)
        assert list(a) == list(b)
        assert list(a) != list(c)
        assert all(x < y for x, y in zip(a, a[1:]))
        assert a[0] >= 0.0

    def test_validation(self):
        with pytest.raises(ValueError):
            ArrivalSpec(0.0)
        with pytest.raises(ValueError):
            ArrivalSpec(1.0, "weibull")
        with pytest.raises(ValueError):
            ArrivalSpec(1.0, start=-1.0)
        with pytest.raises(ValueError):
            ArrivalSpec(1.0).times(0)


# ---------------------------------------------------------------------- #
# steady-state pricing + replication
# ---------------------------------------------------------------------- #
class TestReplication:
    def test_busy_times_price_compute_and_comm(self):
        wf = chain_workflow(2)
        plat = unit_procs(2)
        q = singleton_mapping(wf, plat)
        busy = proc_busy_times(q, plat, include_comm=True)
        # 2.0 work / speed 1 + edge 1.0 / beta 1 on both endpoints
        assert busy == {0: 3.0, 1: 3.0}
        nc = proc_busy_times(q, plat, include_comm=False)
        assert nc == {0: 2.0, 1: 2.0}

    def test_groups_disjoint_and_dominant(self, plat, family_wfs):
        rep = schedule(family_wfs["genome"], plat, kprime=[3],
                       workers=1)
        plan = replicate_plan(rep.best, plat)
        assert plan.n_replicas >= 2
        seen: set[int] = set()
        for g in plan.groups:
            procs = set(g.procs)
            assert not (procs & seen)
            seen |= procs
        base = plan.groups[0]
        for g in plan.groups[1:]:
            for (b, _), (_, r) in zip(base.proc_map, g.proc_map):
                assert plat.procs[r].speed >= plat.procs[b].speed
                assert plat.procs[r].memory >= plat.procs[b].memory
            assert g.latency <= base.latency * (1 + 1e-12)
        assert plan.rate == plan.n_replicas / plan.period
        assert plan.period == max(g.period for g in plan.groups)

    def test_max_replicas_one_is_unreplicated(self, plat, family_wfs):
        rep = schedule(family_wfs["genome"], plat, kprime=[3],
                       workers=1)
        plan = replicate_plan(rep.best, plat, max_replicas=1)
        assert plan.n_replicas == 1
        assert plan.rate == 1.0 / plan.period

    def test_identity_group_latency_is_analytic_makespan(
            self, plat, family_wfs):
        rep = schedule(family_wfs["blast"], plat, kprime=[4], workers=1)
        plan = replicate_plan(rep.best, plat)
        assert plan.groups[0].latency == rep.makespan

    def test_plan_round_trips(self, plat, family_wfs):
        rep = schedule(family_wfs["genome"], plat, kprime=[3],
                       workers=1)
        plan = replicate_plan(rep.best, plat, latency_bound=1e12)
        again = ThroughputPlan.from_dict(
            json.loads(json.dumps(plan.to_dict())))
        assert again == plan


# ---------------------------------------------------------------------- #
# the identity anchor
# ---------------------------------------------------------------------- #
class TestIdentityAnchor:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_rate_to_zero_bit_exact_n1000(self, family, family_wfs,
                                          plat):
        """One instance at arrival 0 IS ``schedule(..., simulate=True)``:
        same specs, same engine — horizon and makespan bit-equal."""
        wf = family_wfs[family]
        rep = schedule(wf, plat, kprime=[6], workers=1, simulate=True)
        assert rep.feasible, family
        p = simulate_pipelined(rep.best, plat, arrivals=[0.0])
        assert p.single_makespan == rep.sim.makespan, family
        assert p.horizon == rep.sim.horizon, family
        assert p.n_instances == 1
        rec = p.instances[0]
        assert rec.arrival == 0.0 and rec.finish == p.horizon
        assert p.memory is not None and p.memory.feasible

    def test_specs_bit_identical_for_instance_zero(self, plat,
                                                   family_wfs):
        from repro_torch.sim import build_specs

        rep = schedule(family_wfs["bwa"], plat, kprime=[4], workers=1)
        q = rep.best.quotient
        plan = replicate_plan(rep.best, plat, max_replicas=1)
        blocks, edges, release, stride = build_pipelined_specs(
            q, plat, plan, [0.0])
        base_blocks, base_edges = build_specs(q, plat)
        assert blocks == list(base_blocks)
        assert sorted((e.src, e.dst, e.volume) for e in edges) == \
            sorted((e.src, e.dst, e.volume) for e in base_edges)
        assert set(release.values()) == {0.0}
        assert stride == max(q.members) + 1


# ---------------------------------------------------------------------- #
# pipelined replay properties
# ---------------------------------------------------------------------- #
class TestPipelinedReplay:
    @settings(max_examples=10, deadline=None)
    @given(
        n_tasks=st.integers(min_value=8, max_value=40),
        seed=st.integers(min_value=0, max_value=10**6),
        n_instances=st.integers(min_value=2, max_value=6),
    )
    def test_makespan_sandwich(self, n_tasks, seed, n_instances):
        """Burst of N instances: single ≤ pipelined horizon ≤
        N × single (pipelining can only help vs. back-to-back runs,
        and interference can only hurt vs. one lone instance)."""
        wf = make_random_dag(n_tasks, seed)
        plat = unit_procs(4)
        rep = schedule(wf, plat, workers=1)
        if not rep.feasible:
            return
        p = simulate_pipelined(rep.best, plat,
                               arrivals=[0.0] * n_instances,
                               memory=False)
        single = p.single_makespan
        assert p.horizon >= single * (1 - 1e-9)
        assert p.horizon <= n_instances * single * (1 + 1e-9)

    def test_deterministic_replay(self, plat, family_wfs):
        rep = schedule(family_wfs["genome"], plat, kprime=[3],
                       workers=1)
        a = simulate_pipelined(rep.best, plat, rate=0.0008,
                               n_instances=8, seed=4, memory=False)
        b = simulate_pipelined(rep.best, plat, rate=0.0008,
                               n_instances=8, seed=4, memory=False)
        assert a.block_start == b.block_start
        assert [r.to_list() for r in a.instances] == \
            [r.to_list() for r in b.instances]

    def test_round_robin_dealing(self, plat, family_wfs):
        rep = schedule(family_wfs["genome"], plat, kprime=[3],
                       workers=1)
        p = simulate_pipelined(rep.best, plat, rate=0.0008,
                               n_instances=6, memory=False)
        assert p.n_replicas >= 2
        assert [r.replica for r in p.instances] == \
            [i % p.n_replicas for i in range(6)]

    def test_replicated_memory_feasible_at_overlap_peak(
            self, plat, family_wfs):
        """Replicated plans never exceed processor
        memory at the overlap peak — asserted via the occupancy
        trace of a saturating burst."""
        rep = schedule(family_wfs["genome"], plat, kprime=[3],
                       workers=1)
        plan = replicate_plan(rep.best, plat)
        assert plan.n_replicas >= 2
        p = simulate_pipelined(rep.best, plat, plan=plan,
                               arrivals=[0.0] * (2 * plan.n_replicas))
        assert p.memory.feasible
        for j, pk in p.memory.peak.items():
            assert pk <= plat.memory(j) * (1 + 1e-9)

    def test_report_round_trips(self, plat, family_wfs):
        rep = schedule(family_wfs["genome"], plat, kprime=[3],
                       workers=1)
        p = simulate_pipelined(rep.best, plat, rate=0.0008,
                               n_instances=4, record_events=True)
        again = PipelinedReport.from_dict(
            json.loads(json.dumps(p.to_dict())))
        assert again.to_dict() == p.to_dict()
        assert again.latencies == p.latencies


# ---------------------------------------------------------------------- #
# summed occupancy tracker: violation pinpointing
# ---------------------------------------------------------------------- #
class TestSummedMemoryTracker:
    def test_violation_names_the_instance(self):
        """Two overlapping instances of one block on one processor:
        the second instance's task start pushes occupancy over, and
        the violation names instance 1 (not 0)."""
        wf = Workflow(1)
        wf.work[:] = [2.0]
        wf.mem[:] = [3.0]
        plat = unit_procs(1, mem=5.0)
        q = build_quotient(wf, [0])
        q.proc[0] = 0
        from repro_torch.core.baseline import MappingResult

        res = MappingResult(algo="test", quotient=q, platform=plat,
                            makespan=makespan(q, plat), runtime_s=0.0,
                            k_used=1, extras={})
        plan = replicate_plan(res, plat, max_replicas=1)
        # overlapping windows (as if the engine had two exec units)
        start = {0: 0.0, 1: 1.0}
        finish = {0: 2.0, 1: 3.0}
        mt = _pipelined_memory_trace(wf, q, plat, plan, start, finish,
                                     stride=1, n_instances=2)
        assert not mt.feasible
        assert mt.peak[0] == 6.0
        v = mt.violations[0]
        assert v.instance == 1 and v.proc == 0 and v.capacity == 5.0
        # serialization keeps the instance attribution
        from repro_torch.sim.report import MemoryViolation

        again = MemoryViolation.from_dict(
            json.loads(json.dumps(v.to_dict())))
        assert again.instance == 1

    def test_single_instance_within_capacity(self):
        wf = Workflow(1)
        wf.work[:] = [2.0]
        wf.mem[:] = [3.0]
        plat = unit_procs(1, mem=5.0)
        q = build_quotient(wf, [0])
        q.proc[0] = 0
        from repro_torch.core.baseline import MappingResult

        res = MappingResult(algo="test", quotient=q, platform=plat,
                            makespan=makespan(q, plat), runtime_s=0.0,
                            k_used=1, extras={})
        plan = replicate_plan(res, plat, max_replicas=1)
        mt = _pipelined_memory_trace(wf, q, plat, plan,
                                     {0: 0.0}, {0: 2.0},
                                     stride=1, n_instances=1)
        assert mt.feasible and mt.peak[0] == 3.0


# ---------------------------------------------------------------------- #
# the scheduler's throughput pipeline
# ---------------------------------------------------------------------- #
class TestThroughputPlanning:
    def test_plan_attached_and_rate_positive(self, plat, family_wfs):
        tr = plan_throughput(family_wfs["genome"], plat, kprime=[3],
                             workers=1)
        assert tr.feasible
        assert tr.rate > 0 and tr.latency > 0
        assert tr.best.extras["throughput"] == tr.plan
        assert tr.plan.n_replicas >= 2

    def test_rate_max_selection_across_sweep(self, plat, family_wfs):
        """The winner maximizes the *replicated rate*, which need not
        be the makespan winner."""
        tr = plan_throughput(family_wfs["genome"], plat,
                             kprime=[3, 9], workers=1)
        assert tr.feasible
        rates = {}
        for pt in tr.report.sweep:
            h = pt.metrics.get("histograms", {}).get("throughput_rate")
            if pt.feasible and h:
                rates[pt.k_prime] = float(h["sum"])
        assert len(rates) == 2
        assert tr.k_prime == max(rates, key=lambda k: rates[k])
        assert tr.rate == pytest.approx(rates[tr.k_prime], rel=1e-12)

    def test_latency_bound_is_structured_infeasibility(
            self, plat, family_wfs):
        tr = plan_throughput(family_wfs["genome"], plat, kprime=[3],
                             workers=1, latency_bound=1e-9)
        assert not tr.feasible
        assert tr.report.infeasibility is not None
        assert tr.report.infeasibility.stage == "throughput"

    def test_latency_bound_caps_replication(self, plat, family_wfs):
        wide = plan_throughput(family_wfs["genome"], plat, kprime=[3],
                               workers=1)
        bound = wide.plan.groups[0].latency  # only group 0 fits a
        tr = plan_throughput(family_wfs["genome"], plat, kprime=[3],
                             workers=1, latency_bound=bound)
        assert tr.feasible
        assert tr.latency <= bound

    def test_saturation_sweep_finds_the_knee(self, plat, family_wfs):
        tr = plan_throughput(family_wfs["genome"], plat, kprime=[3],
                             workers=1)
        rows = saturation_sweep(
            tr.best, plat, plan=tr.plan,
            rates=[0.3 * tr.rate, 3.0 * tr.rate], n_instances=16)
        assert not rows[0]["saturated"]
        assert rows[1]["saturated"]
        assert rows[1]["p99"] >= rows[0]["p99"]
        for row in rows:
            assert row["p50"] <= row["p99"]


# ---------------------------------------------------------------------- #
# sustained service admission
# ---------------------------------------------------------------------- #
class TestRunSustained:
    def test_cold_then_seeded_identical_timings(self, plat,
                                                family_wfs):
        wf = family_wfs["genome"]
        cache = PlanCache(8)
        a = run_sustained(wf, plat, rate=0.0008, n_instances=8,
                          seed=2, cache=cache, kprime=[3])
        b = run_sustained(wf, plat, rate=0.0008, n_instances=8,
                          seed=2, cache=cache, kprime=[3])
        assert a.jobs[0].planning_path == "cold"
        assert b.jobs[0].planning_path == "seeded"
        assert a.cache_stats["service_cache_misses"] == 1
        assert b.cache_stats["service_cache_hits"] == 1
        assert [j.finish_t for j in a.jobs] == \
            [j.finish_t for j in b.jobs]

    def test_report_carries_throughput_views(self, plat, family_wfs):
        rep = run_sustained(family_wfs["genome"], plat, rate=0.0008,
                            n_instances=8, kprime=[3])
        assert len(rep.jobs) == 8
        assert all(j.status == "completed" for j in rep.jobs)
        assert rep.instances_per_s > 0
        assert rep.saturation_rate > 0
        pct = rep.instance_latency_percentiles
        assert pct is not None and pct["p50"] <= pct["p99"]
        assert rep.pipelined is not None
        assert rep.pipelined.memory.feasible
        # allocation is the replica group's processor names
        assert rep.jobs[0].allocation
        # the trace JSON round-trips (pipelined/spans excluded)
        from repro_torch.service import ServiceReport

        again = ServiceReport.from_json(rep.to_json())
        assert again.trace.to_dict() == rep.trace.to_dict()

    def test_infeasible_is_structured(self, plat, family_wfs):
        rep = run_sustained(family_wfs["genome"], plat, rate=0.0008,
                            n_instances=4, kprime=[3],
                            latency_bound=1e-9)
        assert len(rep.jobs) == 1
        assert rep.jobs[0].status == "infeasible"
        assert rep.jobs[0].infeasibility["stage"] == "throughput"
        assert rep.pipelined is None


# ---------------------------------------------------------------------- #
# per-instance trace tooling
# ---------------------------------------------------------------------- #
class TestInstanceTraceTooling:
    def test_stride_decoding_and_per_instance_tracks(
            self, tmp_path, plat, family_wfs):
        from repro_torch.obs.export import sim_proc_events, write_chrome_trace

        rep = schedule(family_wfs["genome"], plat, kprime=[3],
                       workers=1)
        p = simulate_pipelined(rep.best, plat, rate=0.0008,
                               n_instances=3, record_events=True,
                               memory=False)
        ev = sim_proc_events(p, stride=p.stride)
        insts = {e["args"]["instance"] for e in ev
                 if e["cat"] == "task"}
        assert insts == {0, 1, 2}
        assert all(e["args"]["vertex"] < p.stride for e in ev
                   if e["cat"] == "task")
        path = tmp_path / "pipe.json"
        write_chrome_trace(path, ev)

        spec = importlib.util.spec_from_file_location(
            "trace_view",
            Path(__file__).resolve().parent.parent
            / "tools" / "trace_view.py")
        tv = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tv)
        spans = tv.load_spans(path)
        tv.split_per_instance(spans)
        tids = {s["tid"] for s in spans}
        assert any("#i1" in t for t in tids)
        out = tv.format_table(spans, 5, False)
        assert "#i" in out

    def test_histogram_mean(self):
        from repro_torch.obs.metrics import Histogram

        h = Histogram()
        assert h.mean is None
        h.observe(2.0)
        h.observe(4.0)
        assert h.mean == 3.0


# ---------------------------------------------------------------------- #
# parity with repro.throughput: the same seeded inputs, each package on
# its own objects, compared under == or byte for byte
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jplat():
    return J.default_cluster()


@pytest.fixture(scope="module")
def jax_family_wfs(jplat):
    return {f: J.generate_workflow(f, ANCHOR_N, seed=1, platform=jplat)
            for f in J.FAMILIES}


def _plan_dict(plan) -> str:
    return json.dumps(plan.to_dict())


def _pipelined_json(rep) -> str:
    return json.dumps(rep.to_dict())


def _pool_neutral(text: str) -> str:
    """A report's JSON with each histogram's ``min``, ``max`` and ``sum``
    set aside (``count`` and the bucket counts stay).  Under ``workers > 1``
    a pool worker runs several k' points, and a point's histogram delta
    carries that worker's earlier observations in ``min`` / ``max`` and
    rounds ``sum`` against them; which worker takes which point is a race,
    in the reference as in the port, so those three fields differ from run
    to run of either package."""
    def walk(x):
        if isinstance(x, dict):
            if "counts" in x and "boundaries" in x:
                return {k: v for k, v in x.items() if k not in ("min", "max", "sum")}
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x
    return json.dumps(walk(json.loads(text)))


def _same_result(tr, jr, pooled=False):
    """Two ``ThroughputResult`` objects agree: the chosen k', the plan (dict
    and JSON), the rate to the bit and the whole sweep's report."""
    assert tr.feasible == jr.feasible
    assert tr.k_prime == jr.k_prime
    norm = _pool_neutral if pooled else (lambda text: text)
    assert (norm(untimed_schedule_json(tr.report))
            == norm(untimed_schedule_json(jr.report)))
    if tr.feasible:
        assert tr.plan.to_dict() == jr.plan.to_dict()
        assert _plan_dict(tr.plan) == _plan_dict(jr.plan)
        assert tr.rate == jr.rate and tr.latency == jr.latency
        assert tr.best.extras["k_prime"] == jr.best.extras["k_prime"]
        assert tr.best.makespan == jr.best.makespan
    else:
        assert (tr.report.infeasibility.to_dict()
                == jr.report.infeasibility.to_dict())


class TestParity:
    @pytest.mark.parametrize("kind", ["poisson", "deterministic"])
    @pytest.mark.parametrize("seed", [0, 7, 2026])
    def test_arrival_times_equal(self, kind, seed):
        ours = ArrivalSpec(2.5, kind, start=1.5).times(257, seed=seed)
        ref = J_tp.ArrivalSpec(2.5, kind, start=1.5).times(257, seed=seed)
        assert list(ours) == list(ref)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_plan_throughput_equal(self, family, family_wfs, plat,
                                   jax_family_wfs, jplat):
        """The full k' sweep of the ``throughput`` pipeline on each n=1000
        family: the same rate winner, plan and report."""
        tr = plan_throughput(family_wfs[family], plat, workers=1)
        jr = J_tp.plan_throughput(jax_family_wfs[family], jplat, workers=1)
        assert tr.feasible, family
        _same_result(tr, jr)

    @pytest.mark.parametrize("workers", [1, 2])
    def test_throughput_pipeline_report_byte_equal(self, workers, family_wfs,
                                                   plat, jax_family_wfs, jplat):
        """``schedule(..., algorithm="throughput")``: the ``ScheduleReport``
        JSON byte for byte (timing aside; under the pool, the histograms'
        worker-dependent fields too), the winner's plan under ``==``."""
        kw = dict(kprime=[3, 6, 9], workers=workers, algorithm="throughput")
        ours = schedule(family_wfs["genome"], plat, **kw)
        ref = J.schedule(jax_family_wfs["genome"], jplat, **kw)
        assert ours.feasible and ours.workers == workers
        norm = _pool_neutral if workers > 1 else (lambda text: text)
        assert norm(untimed_schedule_json(ours)) == norm(untimed_schedule_json(ref))
        assert (ours.best.extras["throughput"].to_dict()
                == ref.best.extras["throughput"].to_dict())
        for p in ours.sweep:
            assert p.metrics["histograms"]["throughput_rate"]["count"] == 1

    @pytest.mark.parametrize("workers", [1, 2])
    def test_plan_throughput_rerun_equal(self, workers, family_wfs, plat,
                                         jax_family_wfs, jplat):
        """A sweep whose rate winner lost the makespan reduction (genome at
        k' 3 vs 9): both packages rerun the same single point."""
        kw = dict(kprime=[3, 9], workers=workers)
        tr = plan_throughput(family_wfs["genome"], plat, **kw)
        jr = J_tp.plan_throughput(jax_family_wfs["genome"], jplat, **kw)
        _same_result(tr, jr, pooled=workers > 1)

    @pytest.mark.parametrize("opts", [
        {"latency_bound": 1e-9},
        {"max_replicas": 1},
        {"include_comm": False},
        {"latency_bound": 1e12, "max_replicas": 2},
    ])
    def test_plan_throughput_options_equal(self, opts, family_wfs, plat,
                                           jax_family_wfs, jplat):
        tr = plan_throughput(family_wfs["genome"], plat, kprime=[3, 6],
                             workers=1, **opts)
        jr = J_tp.plan_throughput(jax_family_wfs["genome"], jplat,
                                  kprime=[3, 6], workers=1, **opts)
        _same_result(tr, jr)

    @pytest.mark.parametrize("family", ["genome", "bwa", "epigenomics"])
    @pytest.mark.parametrize("include_comm", [True, False])
    def test_replicate_plan_and_busy_times_equal(self, family, include_comm,
                                                 family_wfs, plat,
                                                 jax_family_wfs, jplat):
        ours = schedule(family_wfs[family], plat, kprime=[3], workers=1)
        ref = J.schedule(jax_family_wfs[family], jplat, kprime=[3], workers=1)
        assert (proc_busy_times(ours.best.quotient, plat, include_comm=include_comm)
                == J_tp.proc_busy_times(ref.best.quotient, jplat,
                                        include_comm=include_comm))
        for max_replicas in (None, 1, 2):
            a = replicate_plan(ours.best, plat, max_replicas=max_replicas,
                               include_comm=include_comm)
            b = J_tp.replicate_plan(ref.best, jplat, max_replicas=max_replicas,
                                    include_comm=include_comm)
            assert _plan_dict(a) == _plan_dict(b)
            assert a.rate == b.rate and a.period == b.period

    def test_build_pipelined_specs_equal(self, family_wfs, plat,
                                         jax_family_wfs, jplat):
        ours = schedule(family_wfs["genome"], plat, kprime=[3], workers=1)
        ref = J.schedule(jax_family_wfs["genome"], jplat, kprime=[3], workers=1)
        arrivals = [0.0, 1.0, 2.5, 2.5, 900.0]
        a = build_pipelined_specs(ours.best.quotient, plat,
                                  replicate_plan(ours.best, plat), arrivals)
        b = J_tp.build_pipelined_specs(ref.best.quotient, jplat,
                                       J_tp.replicate_plan(ref.best, jplat),
                                       arrivals)
        blocks, edges, release, stride = a
        jblocks, jedges, jrelease, jstride = b
        assert [(x.vid, x.proc, x.duration) for x in blocks] == \
            [(x.vid, x.proc, x.duration) for x in jblocks]
        assert [(e.src, e.dst, e.volume) for e in edges] == \
            [(e.src, e.dst, e.volume) for e in jedges]
        assert release == jrelease and stride == jstride

    @pytest.mark.parametrize("family", FAMILIES)
    def test_simulate_pipelined_json_equal(self, family, family_wfs, plat,
                                           jax_family_wfs, jplat):
        """Eight Poisson instances at 0.8 x the replicated rate, memory and
        events recorded: the report's JSON byte for byte (seismology's
        overlapping instances exceed a processor's memory in both), and
        the identity anchor of one instance at 0."""
        ours = schedule(family_wfs[family], plat, kprime=[6], workers=1)
        ref = J.schedule(jax_family_wfs[family], jplat, kprime=[6], workers=1)
        rate = 0.8 * replicate_plan(ours.best, plat).rate
        a = simulate_pipelined(ours.best, plat, rate=rate, n_instances=8,
                               seed=3, record_events=True)
        b = J_tp.simulate_pipelined(ref.best, jplat, rate=rate, n_instances=8,
                                    seed=3, record_events=True)
        assert _pipelined_json(a) == _pipelined_json(b)
        assert a.latencies == b.latencies
        solo = simulate_pipelined(ours.best, plat, arrivals=[0.0])
        jsolo = J_tp.simulate_pipelined(ref.best, jplat, arrivals=[0.0])
        assert _pipelined_json(solo) == _pipelined_json(jsolo)
        assert solo.single_makespan == jsolo.single_makespan == ours.makespan

    @pytest.mark.parametrize("comm", ["contention-free", "fair-share"])
    def test_burst_with_memory_equal(self, comm, family_wfs, plat,
                                     jax_family_wfs, jplat):
        """A saturating burst on every replica group (the overlap peak of
        the summed occupancy tracker), under both comm models."""
        ours = schedule(family_wfs["genome"], plat, kprime=[3], workers=1)
        ref = J.schedule(jax_family_wfs["genome"], jplat, kprime=[3], workers=1)
        n = 2 * replicate_plan(ours.best, plat).n_replicas
        a = simulate_pipelined(ours.best, plat, arrivals=[0.0] * n, comm=comm)
        b = J_tp.simulate_pipelined(ref.best, jplat, arrivals=[0.0] * n, comm=comm)
        assert _pipelined_json(a) == _pipelined_json(b)

    def test_memory_violation_attribution_equal(self):
        """The two-instance overlap of one block on one processor: the same
        violation, naming instance 1."""
        from repro.throughput.pipeline import _pipelined_memory_trace as j_trace
        from repro_torch.core.baseline import MappingResult
        import repro_torch.core as T

        out = []
        for core, result, quotient, replicate, trace in (
                (T, MappingResult, build_quotient, replicate_plan,
                 _pipelined_memory_trace),
                (J, JMappingResult, j_build_quotient, J_tp.replicate_plan, j_trace)):
            wf = core.Workflow(1)
            wf.work[:] = [2.0]
            wf.mem[:] = [3.0]
            pl = core.Platform([core.Processor("p0", 1.0, 5.0)], 1.0)
            q = quotient(wf, [0])
            q.proc[0] = 0
            res = result(algo="test", quotient=q, platform=pl,
                         makespan=core.makespan(q, pl), runtime_s=0.0, k_used=1,
                         extras={})
            mt = trace(wf, q, pl, replicate(res, pl, max_replicas=1),
                       {0: 0.0, 1: 1.0}, {0: 2.0, 1: 3.0}, stride=1, n_instances=2)
            out.append(json.dumps(mt.to_dict()))
        assert out[0] == out[1]
        assert json.loads(out[0])["violations"][0]["instance"] == 1

    @settings(max_examples=10, deadline=None)
    @given(
        n_tasks=st.integers(min_value=8, max_value=40),
        seed=st.integers(min_value=0, max_value=10**6),
        n_instances=st.integers(min_value=2, max_value=6),
    )
    def test_random_dag_bursts_equal(self, n_tasks, seed, n_instances):
        wf = make_random_dag(n_tasks, seed)
        jwf = make_random_dag(n_tasks, seed, core=J)
        pl = Platform([Processor(f"p{i}", 1.0 + i, 1e9) for i in range(4)], 1.0)
        jpl = J.Platform([J.Processor(f"p{i}", 1.0 + i, 1e9) for i in range(4)], 1.0)
        ours, ref = schedule(wf, pl, workers=1), J.schedule(jwf, jpl, workers=1)
        assert ours.feasible == ref.feasible
        if not ours.feasible:
            return
        a = simulate_pipelined(ours.best, pl, arrivals=[0.0] * n_instances)
        b = J_tp.simulate_pipelined(ref.best, jpl, arrivals=[0.0] * n_instances)
        assert _pipelined_json(a) == _pipelined_json(b)

    @pytest.mark.parametrize("n_instances", [16, 64])
    def test_saturation_sweep_rows_equal(self, n_instances, family_wfs, plat,
                                         jax_family_wfs, jplat):
        tr = plan_throughput(family_wfs["genome"], plat, kprime=[3], workers=1)
        jr = J_tp.plan_throughput(jax_family_wfs["genome"], jplat, kprime=[3],
                                  workers=1)
        rates = [f * tr.rate for f in (0.3, 0.5, 0.8, 0.95, 1.1, 3.0)]
        ours = saturation_sweep(tr.best, plat, plan=tr.plan, rates=rates,
                                n_instances=n_instances)
        ref = J_tp.saturation_sweep(jr.best, jplat, plan=jr.plan, rates=rates,
                                    n_instances=n_instances)
        assert json.dumps(ours) == json.dumps(ref)

    @pytest.mark.parametrize("workers", [1, 2])
    def test_run_sustained_cold_then_seeded_equal(self, workers, family_wfs,
                                                  plat, jax_family_wfs, jplat):
        """Two runs through one cache in each package: the ``ServiceReport``
        JSON byte for byte with the wall clock set aside, the trace whole,
        and the live pipelined replays' JSON."""
        cache, jcache = PlanCache(8), J_service.PlanCache(8)
        kw = dict(rate=0.0008, n_instances=8, seed=2, kprime=[3, 6],
                  workers=workers)
        for path in ("cold", "seeded"):
            a = run_sustained(family_wfs["genome"], plat, cache=cache, **kw)
            b = J_service.run_sustained(jax_family_wfs["genome"], jplat,
                                        cache=jcache, **kw)
            assert a.jobs[0].planning_path == path
            assert a.trace.to_json() == b.trace.to_json()
            norm = _pool_neutral if workers > 1 else (lambda text: text)
            assert norm(untimed_service_json(a)) == norm(untimed_service_json(b))
            assert _pipelined_json(a.pipelined) == _pipelined_json(b.pipelined)

    def test_run_sustained_infeasible_equal(self, family_wfs, plat,
                                            jax_family_wfs, jplat):
        kw = dict(rate=0.0008, n_instances=4, kprime=[3], latency_bound=1e-9)
        a = run_sustained(family_wfs["genome"], plat, **kw)
        b = J_service.run_sustained(jax_family_wfs["genome"], jplat, **kw)
        assert a.jobs[0].status == "infeasible"
        assert untimed_service_json(a) == untimed_service_json(b)
