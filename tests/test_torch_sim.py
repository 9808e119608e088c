"""The port's discrete-event simulator, ``repro_torch.sim``.

Every case of ``tests/test_sim.py``, on the port alone: under the paper's
model (contention-free links, deterministic durations) the simulated
makespan is **bit-identical** to the analytic bottom-weight
:func:`makespan` for every valid mapping — for the outputs of *both*
pipelines on all seven n=1000 families, and over random valid mappings of
those instances; contention ordering, jitter seeding, the transient-memory
tracker, SimReport JSON round trips, per-link overrides and the
scheduler's ``simulate`` stage.

Then parity with ``repro.sim`` on the same seeded inputs, each package on
its own objects: ``SimReport.to_json`` byte for byte over the seven
families x both algorithms x both comm models, the jitter envelopes of
both kinds, ``trace_memory`` and ``validate_mapping(memory_trace=True)``,
random valid mappings, an engine paused at ``stop_time`` and resumed, and
``schedule(..., simulate=True)`` at ``workers`` 1 and 2 (timing set aside).
"""
import math
import random

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep absent: seeded-random fallback
    from _hypothesis_fallback import given, settings, st

import repro.core as J
import repro.sim as J_sim
import repro_torch.core as T
import repro_torch.sim as T_sim
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
    simulate_peak_members,
    validate_mapping,
)
from repro_torch.core.baseline import MappingResult
from repro_torch.core.dag import build_quotient
from repro_torch.sim import (
    BlockSpec,
    ContentionFreeComm,
    EdgeSpec,
    FairShareComm,
    SimReport,
    run_engine,
    simulate,
    trace_memory,
)

from _torch_parity import fresh_metrics, untimed_schedule_json  # noqa: F401 (fixture)

ANCHOR_N = 1000


@pytest.fixture(scope="module")
def plat() -> Platform:
    return default_cluster()


@pytest.fixture(scope="module")
def family_wfs(plat):
    """The seven n=1000 instances, generated once per module."""
    return {f: generate_workflow(f, ANCHOR_N, seed=1, platform=plat)
            for f in FAMILIES}


@pytest.fixture(scope="module")
def port_reports(family_wfs, plat):
    """``schedule()`` of each n=1000 instance, run once per (family,
    algorithm) and shared by the anchor and the parity cases."""
    cache = {}

    def get(family, algo):
        if (family, algo) not in cache:
            cache[family, algo] = schedule(family_wfs[family], plat, algorithm=algo)
        return cache[family, algo]
    return get


def unit_procs(k: int, mem: float = 1e9) -> Platform:
    return Platform([Processor(f"p{i}", 1.0, mem) for i in range(k)], 1.0)


def make_result(wf, q, platform, orders=None) -> MappingResult:
    extras = {} if orders is None else {"orders": orders}
    return MappingResult(algo="test", quotient=q, platform=platform,
                         makespan=makespan(q, platform), runtime_s=0.0,
                         k_used=q.n_vertices, extras=extras)


# ---------------------------------------------------------------------- #
# the correctness anchor
# ---------------------------------------------------------------------- #
class TestAnalyticAnchor:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_bit_exact_both_pipelines_n1000(self, family, port_reports):
        for algo in ("dag_het_part", "dag_het_mem"):
            rep = port_reports(family, algo)
            assert rep.feasible, (family, algo)
            sim = simulate(rep.best, memory=False, record_events=False)
            assert sim.exact_anchor
            assert sim.makespan == rep.makespan, (family, algo)
            # the analytic value the report carries agrees too
            assert sim.analytic_makespan == rep.makespan
            # forward trace agrees to round-off (it folds the same
            # terms from the other end)
            assert sim.horizon == pytest.approx(sim.makespan, rel=1e-12)

    @settings(max_examples=15, deadline=None)
    @given(
        family=st.sampled_from(FAMILIES),
        n_blocks=st.integers(min_value=1, max_value=36),
        seed=st.integers(min_value=0, max_value=10**6),
    )
    def test_random_valid_mappings_bit_exact(
            self, family_wfs, plat, family, n_blocks, seed):
        """Contiguous cuts of a topological order give an acyclic
        quotient; with distinct processors that is a valid mapping
        shape — the simulated makespan must match Eq. (2) bit-exactly
        on every one of them."""
        wf = family_wfs[family]
        rng = random.Random(seed)
        order = wf.topological_order()
        cuts = sorted(rng.sample(range(1, wf.n), n_blocks - 1)) \
            if n_blocks > 1 else []
        block_of = [0] * wf.n
        b = 0
        bounds = cuts + [wf.n]
        lo = 0
        for b, hi in enumerate(bounds):
            for i in range(lo, hi):
                block_of[order[i]] = b
            lo = hi
        q = build_quotient(wf, block_of)
        procs = rng.sample(range(plat.k), len(q.members))
        for pj, vid in zip(procs, sorted(q.members)):
            q.proc[vid] = pj
        sim = simulate(make_result(wf, q, plat), memory=False,
                       record_events=False)
        assert sim.makespan == makespan(q, plat)


# ---------------------------------------------------------------------- #
# contention model
# ---------------------------------------------------------------------- #
def fan_out_workflow():
    """0 → 1 (c=2), 0 → 2 (c=4); singleton blocks on three procs."""
    wf = Workflow(3)
    wf.work[:] = [1.0, 1.0, 1.0]
    wf.mem[:] = [1.0, 1.0, 1.0]
    wf.add_edge(0, 1, 2.0)
    wf.add_edge(0, 2, 4.0)
    q = build_quotient(wf, [0, 1, 2])
    for vid in q.members:
        q.proc[vid] = vid
    return wf, q


class TestContention:
    def test_contention_free_reference(self):
        wf, q = fan_out_workflow()
        plat = unit_procs(3)
        sim = simulate(make_result(wf, q, plat))
        assert sim.makespan == makespan(q, plat) == 6.0
        xf = {(t.src, t.dst): (t.start, t.finish) for t in sim.transfers}
        assert xf == {(0, 1): (1.0, 3.0), (0, 2): (1.0, 5.0)}

    def test_fair_share_egress_serializes_fan_out(self):
        wf, q = fan_out_workflow()
        plat = unit_procs(3)
        sim = simulate(make_result(wf, q, plat), comm="fair-share")
        # both transfers share block 0's egress port at rate 1/2 until
        # the smaller one drains: (0,1) lands at 1 + 2/(1/2) = 5, then
        # (0,2) finishes its remaining 2 units at full rate at t = 7
        xf = {(t.src, t.dst): (t.start, t.finish) for t in sim.transfers}
        assert xf[(0, 1)] == (1.0, 5.0)
        assert xf[(0, 2)] == (1.0, 7.0)
        assert sim.makespan == sim.horizon == 8.0
        assert not sim.exact_anchor
        # event ordering: (0,1) completes strictly before (0,2)
        done = [e.edge for e in sim.events if e.kind == "transfer_finish"]
        assert done == [(0, 1), (0, 2)]

    def test_link_only_model_has_no_fan_out_contention(self):
        wf, q = fan_out_workflow()
        plat = unit_procs(3)
        sim = simulate(make_result(wf, q, plat),
                       comm=FairShareComm(egress=False, ingress=False))
        # distinct destination links: degenerates to contention-free
        assert sim.horizon == 6.0

    def test_ingress_contention_on_join(self):
        # 0 → 2 (c=2), 1 → 2 (c=2): both land on proc of block 2
        wf = Workflow(3)
        wf.work[:] = [1.0, 1.0, 1.0]
        wf.add_edge(0, 2, 2.0)
        wf.add_edge(1, 2, 2.0)
        q = build_quotient(wf, [0, 1, 2])
        for vid in q.members:
            q.proc[vid] = vid
        plat = unit_procs(3)
        sim = simulate(make_result(wf, q, plat), comm="fair-share")
        # both start at t=1 sharing the ingress port: both land at 5
        xf = {(t.src, t.dst): t.finish for t in sim.transfers}
        assert xf == {(0, 2): 5.0, (1, 2): 5.0}
        assert sim.horizon == 6.0

    def test_per_link_override_respected(self):
        # chain 0 → 1 (c=2) with the 0→1 link halved
        wf = Workflow(2)
        wf.work[:] = [1.0, 1.0]
        wf.add_edge(0, 1, 2.0)
        q = build_quotient(wf, [0, 1])
        q.proc[0], q.proc[1] = 0, 1
        plat = unit_procs(2).with_link_bandwidth(0, 1, 0.5)
        sim = simulate(make_result(wf, q, plat))
        assert sim.makespan == 1.0 + 2.0 / 0.5 + 1.0
        assert not sim.exact_anchor  # analytic uses the uniform beta

    def test_asymmetric_override_consistent_with_trace(self):
        # the backward (canonical-makespan) pass must price the 0→1
        # link, not the unused 1→0 direction it traverses transposed
        wf = Workflow(2)
        wf.work[:] = [1.0, 1.0]
        wf.add_edge(0, 1, 2.0)
        q = build_quotient(wf, [0, 1])
        q.proc[0], q.proc[1] = 0, 1
        plat = unit_procs(2).with_link_bandwidth(0, 1, 0.5,
                                                 symmetric=False)
        sim = simulate(make_result(wf, q, plat))
        assert sim.makespan == sim.horizon == 6.0
        assert sim.block_finish[1] == 6.0

    def test_fair_share_same_proc_transfer_is_free(self):
        # data between two blocks pinned to one processor never touches
        # the network: no egress/ingress/link consumption
        wf = Workflow(2)
        wf.work[:] = [1.0, 1.0]
        wf.add_edge(0, 1, 4.0)
        q = build_quotient(wf, [0, 1])
        q.proc[0] = q.proc[1] = 0
        plat = unit_procs(1)
        sim = simulate(make_result(wf, q, plat), comm="fair-share")
        assert sim.horizon == 2.0  # matches the contention-free model

    def test_non_injective_mapping_serializes_on_processor(self):
        # two independent blocks pinned to the same processor
        wf = Workflow(2)
        wf.work[:] = [2.0, 3.0]
        q = build_quotient(wf, [0, 1])
        q.proc[0] = q.proc[1] = 0
        plat = unit_procs(1)
        sim = simulate(make_result(wf, q, plat))
        assert sim.horizon == 5.0
        assert sim.makespan == 5.0  # backward anchor disabled
        assert not sim.exact_anchor
        # the analytic proxy ignores the sharing
        assert sim.analytic_makespan == 3.0


# ---------------------------------------------------------------------- #
# stochastic durations
# ---------------------------------------------------------------------- #
class TestJitter:
    def setup_method(self):
        self.plat = default_cluster()
        self.wf = generate_workflow("montage", 120, seed=3,
                                    platform=self.plat)
        self.res = schedule(self.wf, self.plat, kprime=[4]).best

    def test_seeding_is_deterministic(self):
        a = simulate(self.res, jitter=0.2, replicas=6, seed=7,
                     memory=False, record_events=False)
        b = simulate(self.res, jitter=0.2, replicas=6, seed=7,
                     memory=False, record_events=False)
        assert a.envelope.makespans == b.envelope.makespans
        c = simulate(self.res, jitter=0.2, replicas=6, seed=8,
                     memory=False, record_events=False)
        assert a.envelope.makespans != c.envelope.makespans

    def test_envelope_brackets_and_headline_stays_deterministic(self):
        sim = simulate(self.res, jitter=0.2, replicas=12, seed=1,
                       memory=False, record_events=False)
        assert sim.makespan == self.res.makespan  # headline unjittered
        env = sim.envelope
        assert len(env.makespans) == 12
        assert env.lo <= env.mean <= env.hi
        assert env.std >= 0.0
        spread = {round(m, 6) for m in env.makespans}
        assert len(spread) > 1  # jitter actually moved the makespan

    def test_uniform_kind_and_zero_replicas_default(self):
        sim = simulate(self.res, jitter=0.1, jitter_kind="uniform",
                       memory=False, record_events=False)
        assert len(sim.envelope.makespans) == 16  # default replicas
        sim0 = simulate(self.res, memory=False, record_events=False)
        assert sim0.envelope is None


# ---------------------------------------------------------------------- #
# memory-occupancy tracking
# ---------------------------------------------------------------------- #
class TestMemoryTrace:
    def test_valid_mappings_have_violation_free_traces(self, plat):
        wf = generate_workflow("bwa", 300, seed=2, platform=plat)
        for algo in ("dag_het_part", "dag_het_mem"):
            rep = schedule(wf, plat, algorithm=algo)
            sim = simulate(rep.best)
            assert sim.memory.feasible
            assert validate_mapping(wf, rep.best, memory_trace=True) == []

    def test_peak_matches_witness_simulation(self, plat):
        wf = generate_workflow("blast", 200, seed=4, platform=plat)
        res = schedule(wf, plat, algorithm="dag_het_mem").best
        sim = simulate(res)
        orders = res.extras["orders"]
        q = res.quotient
        for vid, members in q.members.items():
            p = q.proc[vid]
            base = sum(wf.persistent[u] for u in members)
            expected = base + simulate_peak_members(wf, members,
                                                    orders[vid])
            assert sim.memory.peak[p] >= expected or \
                math.isclose(sim.memory.peak[p], expected)
        # single block per proc here -> equality for each proc's block
        for vid, members in q.members.items():
            base = sum(wf.persistent[u] for u in members)
            assert sim.memory.peak[q.proc[vid]] == \
                base + simulate_peak_members(wf, members, orders[vid])

    def test_trace_catches_witness_only_violation(self):
        """Block sums pass (a better traversal exists) but the planned
        witness order transiently overflows — the tracker reports the
        exact time-point, processor and task."""
        wf = Workflow(3)
        wf.work[:] = [1.0, 3.0, 2.0]   # a, b, c
        wf.mem[:] = [1.0, 1.0, 50.0]
        wf.add_edge(0, 1, 10.0)        # a -> b internal file
        q = build_quotient(wf, [0, 0, 0])
        (vid,) = q.members
        q.proc[vid] = 0
        cap = 55.0
        plat = Platform([Processor("p0", 1.0, cap)], 1.0)
        # witness holds a->b live while c runs: peak 60 > 55;
        # the traversal [a, b, c] peaks at 50 and certifies the sum
        res = make_result(wf, q, plat, orders={vid: [0, 2, 1]})
        assert validate_mapping(wf, res) == []  # block sums fine
        errors = validate_mapping(wf, res, memory_trace=True)
        assert len(errors) == 1
        msg = errors[0]
        assert "transient memory violation" in msg
        assert "t=1" in msg and "task 2" in msg and "processor 0" in msg
        sim = simulate(res)
        v = sim.memory.violations[0]
        assert (v.time, v.proc, v.task, v.occupancy) == (1.0, 0, 2, 60.0)
        # the same mapping with the good witness is trace-clean
        ok = make_result(wf, q, plat, orders={vid: [0, 1, 2]})
        assert validate_mapping(wf, ok, memory_trace=True) == []

    def test_invalid_witness_falls_back_to_greedy(self):
        wf = Workflow(2)
        wf.work[:] = [1.0, 1.0]
        wf.add_edge(0, 1, 2.0)
        q = build_quotient(wf, [0, 0])
        (vid,) = q.members
        q.proc[vid] = 0
        plat = unit_procs(1)
        # precedence-violating witness is ignored, not replayed
        res = make_result(wf, q, plat, orders={vid: [1, 0]})
        sim = simulate(res)
        assert sim.memory.feasible


# ---------------------------------------------------------------------- #
# report plumbing
# ---------------------------------------------------------------------- #
class TestSimReport:
    def test_json_round_trip_full(self, plat):
        wf = generate_workflow("montage", 150, seed=5, platform=plat)
        res = schedule(wf, plat, kprime=[4]).best
        sim = simulate(res, jitter=0.1, replicas=4)
        back = SimReport.from_json(sim.to_json())
        assert back.makespan == sim.makespan
        assert back.horizon == sim.horizon
        assert back.exact_anchor == sim.exact_anchor
        assert back.block_start == sim.block_start
        assert back.block_finish == sim.block_finish
        assert back.block_proc == sim.block_proc
        assert back.transfers == sim.transfers
        assert back.procs == sim.procs
        assert back.events == sim.events
        assert back.memory.per_proc == sim.memory.per_proc
        assert back.memory.peak == sim.memory.peak
        assert back.envelope.makespans == sim.envelope.makespans
        assert back.to_json() == sim.to_json()

    def test_utilization_and_gantt(self):
        wf, q = fan_out_workflow()
        plat = unit_procs(3)
        sim = simulate(make_result(wf, q, plat))
        by_proc = {p.proc: p for p in sim.procs}
        assert by_proc[0].busy_s == 1.0
        assert by_proc[0].utilization == pytest.approx(1.0 / 6.0)
        assert by_proc[0].idle_s == pytest.approx(5.0)
        g = sim.gantt(width=30)
        assert len(g.splitlines()) == 4  # header + 3 proc rows
        assert "█" in g and "busy" in g

    def test_infeasible_report_raises(self, plat):
        wf = generate_workflow("blast", 50, seed=1)
        for u in range(wf.n):
            wf.mem[u] = 1e9  # nothing fits anywhere
        rep = schedule(wf, plat, kprime=[2])
        assert not rep.feasible
        with pytest.raises(ValueError, match="no feasible mapping"):
            simulate(rep)


# ---------------------------------------------------------------------- #
# scheduler integration
# ---------------------------------------------------------------------- #
class TestSimulateStage:
    def test_stage_attaches_report(self, plat):
        wf = generate_workflow("seismology", 120, seed=2, platform=plat)
        rep = schedule(wf, plat, kprime=[4], simulate=True)
        assert isinstance(rep.sim, SimReport)
        assert rep.sim.makespan == rep.makespan
        assert rep.sim.exact_anchor

    def test_stage_options_and_default_off(self, plat):
        wf = generate_workflow("seismology", 120, seed=2, platform=plat)
        rep = schedule(wf, plat, kprime=[4])
        assert rep.sim is None
        rep = schedule(wf, plat, kprime=[4], simulate=True,
                       sim_options={"comm": "fair-share",
                                    "memory": False})
        assert rep.sim.comm.startswith("fair-share")
        assert rep.sim.memory is None
        assert rep.sim.makespan >= rep.makespan

    def test_stage_in_parallel_sweep(self, plat):
        wf = generate_workflow("bwa", 150, seed=2, platform=plat)
        rep = schedule(wf, plat, kprime=[2, 4, 6], workers=2,
                       simulate=True,
                       sim_options={"record_events": False})
        serial = schedule(wf, plat, kprime=[2, 4, 6], simulate=True,
                          sim_options={"record_events": False})
        assert rep.sim is not None
        assert rep.sim.makespan == serial.sim.makespan == rep.makespan

    def test_pack_pipeline_has_simulate_stage_too(self, plat):
        wf = generate_workflow("genome", 120, seed=2, platform=plat)
        rep = schedule(wf, plat, algorithm="dag_het_mem", simulate=True)
        assert rep.sim is not None
        assert rep.sim.makespan == rep.makespan


# ---------------------------------------------------------------------- #
# per-link platform overrides
# ---------------------------------------------------------------------- #
class TestPlatformLinks:
    def test_override_and_uniform_default(self):
        p = unit_procs(6).with_link_bandwidth(0, 5, 9.0)
        assert p.bandwidth_between(0, 5) == 9.0
        assert p.bandwidth_between(5, 0) == 9.0  # symmetric default
        assert p.bandwidth_between(0, 1) == 1.0
        assert math.isinf(p.bandwidth_between(3, 3))
        q = unit_procs(6).with_link_bandwidth(0, 5, 9.0, symmetric=False)
        assert q.bandwidth_between(5, 0) == 1.0

    def test_without_reindexes_links(self):
        p = unit_procs(6).with_link_bandwidth(0, 5, 9.0)
        d = p.without({1, 2})
        # old 5 is new 3; the override survives the renumbering
        assert d.k == 4
        assert d.bandwidth_between(0, 3) == 9.0
        assert d.bandwidth_between(3, 0) == 9.0
        assert d.bandwidth_between(0, 1) == 1.0

    def test_zero_or_negative_link_bandwidth_rejected(self):
        p = unit_procs(3)
        with pytest.raises(ValueError, match="positive"):
            p.with_link_bandwidth(0, 1, 0.0)
        with pytest.raises(ValueError, match="positive"):
            p.with_link_bandwidth(0, 1, -2.0)
        assert p.with_link_bandwidth(0, 1, math.inf) \
            .bandwidth_between(0, 1) == math.inf

    def test_without_drops_links_of_failed_procs(self):
        p = unit_procs(6).with_link_bandwidth(0, 5, 9.0)
        d = p.without({5})
        assert d.link_bandwidth == {}

    def test_with_bandwidth_keeps_overrides(self):
        p = unit_procs(6).with_link_bandwidth(0, 5, 9.0)
        r = p.with_bandwidth(2.0)
        assert r.bandwidth == 2.0
        assert r.bandwidth_between(0, 5) == 9.0
        assert r.bandwidth_between(0, 1) == 2.0

    def test_composition_failure_scenario(self):
        # configure links, fail a node, rescale beta: config survives
        p = (unit_procs(5)
             .with_link_bandwidth(1, 4, 0.25)
             .with_link_bandwidth(0, 2, 8.0))
        d = p.without({3}).with_bandwidth(0.5)
        assert d.bandwidth_between(1, 3) == 0.25   # old 4 -> new 3
        assert d.bandwidth_between(0, 2) == 8.0
        assert d.bandwidth_between(2, 1) == 0.5


# ---------------------------------------------------------------------- #
# raw engine edge cases
# ---------------------------------------------------------------------- #
class TestEngine:
    def test_cycle_detection(self):
        plat = unit_procs(2)
        blocks = [BlockSpec(0, 0, 1.0), BlockSpec(1, 1, 1.0)]
        edges = [EdgeSpec(0, 1, 1.0), EdgeSpec(1, 0, 1.0)]
        with pytest.raises(ValueError, match="cyclic"):
            run_engine(blocks, edges, ContentionFreeComm(), plat)

    def test_empty_and_single(self):
        plat = unit_procs(1)
        t = run_engine([], [], ContentionFreeComm(), plat)
        assert t.horizon == 0.0
        t = run_engine([BlockSpec(7, 0, 2.5)], [], ContentionFreeComm(),
                       plat)
        assert t.start[7] == 0.0 and t.finish[7] == 2.5


# ---------------------------------------------------------------------- #
# parity with repro.sim: the same seeded inputs, each package on its own
# objects, compared under == or byte for byte
# ---------------------------------------------------------------------- #
ALGORITHMS = ("dag_het_part", "dag_het_mem")
COMMS = ("contention-free", "fair-share")
#: each package's core, simulator, MappingResult and build_quotient
SIDES = ((T, T_sim, MappingResult, build_quotient),
         (J, J_sim, JMappingResult, j_build_quotient))


@pytest.fixture(scope="module")
def jax_reports():
    """JAX's ``schedule()`` of the same n=1000 instances, once each."""
    jplat = J.default_cluster()
    wfs, cache = {}, {}

    def get(family, algo):
        if family not in wfs:
            wfs[family] = J.generate_workflow(family, ANCHOR_N, seed=1, platform=jplat)
        if (family, algo) not in cache:
            cache[family, algo] = J.schedule(wfs[family], jplat, algorithm=algo)
        return cache[family, algo]
    return get


def _cut_mapping(core, mapping_result, quotient, family, n_blocks, seed):
    """Contiguous cuts of a topological order on distinct processors (as
    ``TestAnalyticAnchor``), built in one package from the given draws."""
    plat = core.default_cluster()
    wf = core.generate_workflow(family, 200, seed=1, platform=plat)
    rng = random.Random(seed)
    order = wf.topological_order()
    cuts = sorted(rng.sample(range(1, wf.n), n_blocks - 1)) if n_blocks > 1 else []
    block_of, lo = [0] * wf.n, 0
    for b, hi in enumerate(cuts + [wf.n]):
        for i in range(lo, hi):
            block_of[order[i]] = b
        lo = hi
    q = quotient(wf, block_of)
    for pj, vid in zip(rng.sample(range(plat.k), len(q.members)), sorted(q.members)):
        q.proc[vid] = pj
    return mapping_result(algo="test", quotient=q, platform=plat,
                          makespan=core.makespan(q, plat), runtime_s=0.0,
                          k_used=q.n_vertices, extras={})


class TestParity:
    @pytest.mark.parametrize("comm", COMMS)
    @pytest.mark.parametrize("algo", ALGORITHMS)
    @pytest.mark.parametrize("family", FAMILIES)
    def test_sim_report_json_byte_equal(self, family, algo, comm, port_reports,
                                        jax_reports):
        ours = simulate(port_reports(family, algo), comm=comm)
        ref = J_sim.simulate(jax_reports(family, algo), comm=comm)
        text = ref.to_json()
        assert ours.to_json() == text
        assert ours.makespan == ref.makespan and ours.memory.feasible
        assert SimReport.from_json(text).to_json() == text
        if comm == "contention-free":
            assert ours.exact_anchor and ours.makespan == ours.analytic_makespan
        else:
            assert ours.makespan >= ours.analytic_makespan

    @pytest.mark.parametrize("kind", ["lognormal", "uniform"])
    @pytest.mark.parametrize("comm", COMMS)
    def test_jitter_envelope_equal(self, kind, comm, port_reports, jax_reports):
        kw = dict(comm=comm, jitter=0.2, jitter_kind=kind, replicas=16, seed=3,
                  memory=False, record_events=False)
        ours = simulate(port_reports("genome", "dag_het_part"), **kw).envelope
        ref = J_sim.simulate(jax_reports("genome", "dag_het_part"), **kw).envelope
        assert ours.to_dict() == ref.to_dict()
        assert (ours.lo, ours.hi, ours.mean, ours.std) == (ref.lo, ref.hi, ref.mean, ref.std)
        assert len(set(ours.makespans)) > 1

    @pytest.mark.parametrize("algo", ALGORITHMS)
    @pytest.mark.parametrize("family", ["bwa", "montage", "soykb"])
    def test_memory_trace_and_validation_equal(self, family, algo, port_reports,
                                               jax_reports):
        rt, rj = port_reports(family, algo), jax_reports(family, algo)
        ours, ref = trace_memory(rt), J_sim.trace_memory(rj)
        assert ours.to_dict() == ref.to_dict() and ours.feasible
        assert validate_mapping(rt.best.quotient.wf, rt.best, memory_trace=True) == \
            J.validate_mapping(rj.best.quotient.wf, rj.best, memory_trace=True) == []

    def test_witness_only_violation_reported_equally(self):
        """The "block sums pass, trace violates" case of
        ``TestMemoryTrace`` through both packages: the same message."""
        msgs = []
        for core, _, mapping_result, quotient in SIDES:
            wf = core.Workflow(3)
            wf.work[:] = [1.0, 3.0, 2.0]
            wf.mem[:] = [1.0, 1.0, 50.0]
            wf.add_edge(0, 1, 10.0)
            q = quotient(wf, [0, 0, 0])
            (vid,) = q.members
            q.proc[vid] = 0
            plat = core.Platform([core.Processor("p0", 1.0, 55.0)], 1.0)
            res = mapping_result(algo="test", quotient=q, platform=plat,
                                 makespan=core.makespan(q, plat), runtime_s=0.0,
                                 k_used=1, extras={"orders": {vid: [0, 2, 1]}})
            msgs.append(core.validate_mapping(wf, res, memory_trace=True))
        assert msgs[0] == msgs[1] and len(msgs[0]) == 1

    @settings(max_examples=10, deadline=None)
    @given(
        family=st.sampled_from(FAMILIES),
        n_blocks=st.integers(min_value=1, max_value=36),
        seed=st.integers(min_value=0, max_value=10**6),
        comm=st.sampled_from(COMMS),
    )
    def test_random_valid_mappings_equal(self, family, n_blocks, seed, comm):
        texts = [sim.simulate(_cut_mapping(core, mr, bq, family, n_blocks, seed),
                              comm=comm).to_json()
                 for core, sim, mr, bq in SIDES]
        assert texts[0] == texts[1]

    @pytest.mark.parametrize("comm", COMMS)
    def test_paused_engine_resumes_to_the_reference_trace(self, comm, port_reports,
                                                          jax_reports):
        """Pause at two instants and resume: the prefix at each pause and
        the final trace equal JAX's run paused at the same instants."""
        traces = []
        for sim, rep in ((T_sim, port_reports("epigenomics", "dag_het_part")),
                         (J_sim, jax_reports("epigenomics", "dag_het_part"))):
            res = rep.best
            blocks, edges = sim.build_specs(res.quotient, res.platform)
            tr = sim.run_engine(blocks, edges, sim.resolve_comm(comm), res.platform,
                                stop_time=0.3 * res.makespan)
            first = (dict(tr.start), dict(tr.finish), sorted(tr.in_flight()), tr.horizon)
            tr = sim.resume_engine(tr.checkpoint, stop_time=0.6 * res.makespan)
            second = (dict(tr.start), dict(tr.finish), sorted(tr.in_flight()), tr.horizon)
            tr = sim.resume_engine(tr.checkpoint)
            assert not tr.paused
            traces.append((first, second, tr.start, tr.finish, tr.xfer_start,
                           tr.xfer_finish, tr.horizon, [e.to_list() for e in tr.events]))
        assert traces[0] == traces[1]
        assert traces[0][0][2] and traces[0][1][2]   # work in flight at both pauses

    @pytest.mark.parametrize("workers", [1, 2])
    def test_schedule_with_simulate_equal(self, workers):
        opts = {"comm": "fair-share", "jitter": 0.1, "replicas": 4}
        out = []
        for core, *_ in SIDES:
            plat = core.default_cluster()
            wf = core.generate_workflow("bwa", 300, seed=2, platform=plat)
            rep = core.schedule(wf, plat, kprime=[2, 4, 6], workers=workers,
                                simulate=True, sim_options=opts)
            out.append((untimed_schedule_json(rep), rep.sim.to_json()))
        assert out[0] == out[1]
