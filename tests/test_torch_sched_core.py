"""The port's scheduler core held to the reference's own properties.

Counterparts, on ``repro_torch.core`` alone, of what the JAX suite holds
for ``repro.core``: the flat Step 1 and Step 2 decision for decision equal
to the scalar ones (``tests/test_step1_flat.py``, ``test_step2_flat.py``),
``IncrementalEvaluator`` against a full recompute after random mutation
sequences (``test_incremental.py``), the ``Platform`` transforms and the
paper's presets (``test_platform_transforms.py``); the post-pipeline
stages (``simulate``, ``reliability``, ``energy``) and the memory trace of
``validate_mapping``; and the ``throughput`` stage, whose package the port
has not copied yet, raises ``NotImplementedError`` naming its
``ROADMAP.md`` item, after the reference's early returns.  Every
comparison of floats is ``==``.
"""
import random

import numpy as np
import pytest

from repro_torch.core import (
    FAMILIES,
    Platform,
    ProcPower,
    Processor,
    Workflow,
    build_quotient,
    counters,
    default_cluster,
    generate_workflow,
    large_cluster,
    less_het_cluster,
    more_het_cluster,
    no_het_cluster,
    schedule,
    small_cluster,
    validate_mapping,
)
from repro_torch.core.dag import QuotientGraph
from repro_torch.core.heuristic import _biggest_assign, _Requirements, _swap_pass
from repro_torch.core.incremental import IncrementalEvaluator
from repro_torch.core.makespan import bottom_weights, critical_path, makespan
from repro_torch.core.memdag import (
    _greedy_min_peak_members_flat,
    _greedy_min_peak_members_scalar,
    _simulate_peak_members_flat,
    greedy_min_peak_members,
    occupancy_steps,
    set_step2_impl,
    step2_impl,
)
from repro_torch.core.partitioner import (
    _acyclic_partition_flat,
    _acyclic_partition_scalar,
    acyclic_partition,
    partition_block,
    set_step1_impl,
    step1_impl,
)
from repro_torch.core.workflows import random_layered_dag
from repro_torch.obs.metrics import METRICS


@pytest.fixture(autouse=True)
def _isolate():
    """The port's metrics registry and both dispatch modes restored after
    every test."""
    snap, s1, s2 = METRICS.snapshot(), step1_impl(), step2_impl()
    yield
    METRICS.restore(snap)
    set_step1_impl(s1)
    set_step2_impl(s2)


def make_random_dag(n: int, seed: int, p: float = 0.3) -> Workflow:
    rng = np.random.default_rng(seed)
    wf = Workflow(n)
    for u in range(n):
        wf.work[u] = float(rng.uniform(1, 100))
        wf.mem[u] = float(rng.uniform(1, 50))
    for u in range(n):
        for v in range(u + 1, n):
            if rng.random() < p:
                wf.add_edge(u, v, float(rng.uniform(1, 10)))
    return wf


def assert_partition_invariants(wf, block_of, k):
    assert len(block_of) == wf.n
    k_eff = max(block_of) + 1
    assert k_eff <= k
    assert sorted(set(block_of)) == list(range(k_eff))
    for u in range(wf.n):
        for v in wf.succ[u]:
            assert block_of[u] <= block_of[v]
    assert build_quotient(wf, block_of).is_acyclic()


# ---------------------------------------------------------------- Step 1
@pytest.mark.parametrize("family", FAMILIES)
def test_step1_flat_equals_scalar_on_families(family):
    wf = generate_workflow(family, 600, seed=7)
    for k in (1, 2, 7, 36):
        a = _acyclic_partition_scalar(wf, k, 0.2, 4)
        assert a == _acyclic_partition_flat(wf, k, 0.2, 4)
        assert_partition_invariants(wf, a, k)


@pytest.mark.parametrize("seed", range(10))
def test_step1_flat_equals_scalar_on_random_dags(seed):
    rng = random.Random(seed)
    n, p, k = rng.randint(2, 150), rng.choice([0.05, 0.15, 0.35]), rng.choice([2, 3, 5, 9])
    wf = make_random_dag(n, seed, p=p)
    a = _acyclic_partition_scalar(wf, k, 0.2, 4)
    assert a == _acyclic_partition_flat(wf, k, 0.2, 4)
    assert_partition_invariants(wf, a, k)


def test_step1_dispatch_modes_agree():
    wf = make_random_dag(600, 11, p=0.02)
    out = {}
    for mode in ("scalar", "flat", "auto"):
        set_step1_impl(mode)
        out[mode] = acyclic_partition(wf, 5)
    assert out["scalar"] == out["flat"] == out["auto"]
    wf = generate_workflow("montage", 800, seed=3)
    nodes = sorted(random.Random(5).sample(range(wf.n), wf.n - 50))
    blocks = {}
    for mode in ("scalar", "flat"):
        set_step1_impl(mode)
        blocks[mode] = partition_block(wf, nodes, 4)
    assert blocks["scalar"] == blocks["flat"]


def test_set_step1_impl_rejects_unknown_and_returns_prev():
    set_step1_impl("auto")
    with pytest.raises(ValueError):
        set_step1_impl("simd")
    assert set_step1_impl("scalar") == "auto"
    assert set_step1_impl("flat") == "scalar"
    assert step1_impl() == "flat"


@pytest.mark.parametrize("family", ["blast", "bwa"])
def test_step1_multilevel_invariants_and_determinism(family):
    wf = generate_workflow(family, 1500, seed=2)
    counters.reset()
    a = acyclic_partition(wf, 4, multilevel=True)
    assert_partition_invariants(wf, a, 4)
    assert a == acyclic_partition(wf, 4, multilevel=True)
    assert counters.snapshot().get("step1_multilevel_calls") == 2


# ---------------------------------------------------------------- Step 2
@pytest.mark.parametrize("seed", range(16))
def test_step2_flat_equals_scalar_on_random_blocks(seed):
    rng = random.Random(seed)
    n = rng.randint(2, 120)
    wf = make_random_dag(n, seed, p=rng.choice([0.05, 0.15, 0.35]))
    nodes = sorted(rng.sample(range(n), rng.randint(1, n)))
    peak, order = _greedy_min_peak_members_scalar(wf, nodes)
    assert (peak, order) == _greedy_min_peak_members_flat(wf, nodes)
    scalar = max([during for _, during, _ in occupancy_steps(wf, set(nodes), order)] + [0.0])
    assert _simulate_peak_members_flat(wf, order) == scalar


def test_step2_dispatch_modes_agree_and_reject_unknown():
    wf = make_random_dag(90, 7, p=0.2)
    out = {}
    for mode in ("scalar", "flat", "auto"):
        set_step2_impl(mode)
        out[mode] = greedy_min_peak_members(wf, list(range(90)))
    assert out["scalar"] == out["flat"] == out["auto"]
    with pytest.raises(ValueError):
        set_step2_impl("simd")


def test_step2_flat_cache_tracks_edits():
    wf = make_random_dag(60, 3, p=0.2)
    nodes = list(range(60))
    _greedy_min_peak_members_flat(wf, nodes)
    view = wf._flat_cache[2]
    u = wf.add_task(work=1.0, mem=2.0)
    wf.add_edge(0, u, 5.0)
    assert _greedy_min_peak_members_flat(wf, nodes + [u]) == \
        _greedy_min_peak_members_scalar(wf, nodes + [u])
    assert wf._flat_cache[2] is not view
    u = next(u for u in range(60) if wf.succ[u])
    wf.add_edge(u, next(iter(wf.succ[u])), 123.0)   # an existing edge: (n, n_edges) unchanged
    assert wf._flat_cache is None
    assert _greedy_min_peak_members_flat(wf, nodes) == _greedy_min_peak_members_scalar(wf, nodes)


@pytest.mark.parametrize("seed,kprime", [(0, 2), (11, 4), (250, 6)])
def test_biggest_assign_flat_equals_scalar(seed, kprime):
    plat = default_cluster()
    wf = generate_workflow("montage", 300, seed=seed, platform=plat)
    out = []
    for mode in ("scalar", "flat"):
        set_step2_impl(mode)
        groups = {}
        for u, b in enumerate(acyclic_partition(wf, kprime)):
            groups.setdefault(b, []).append(u)
        step2 = _biggest_assign(wf, plat, [groups[b] for b in sorted(groups)],
                                exact_limit=0, memo={})
        out.append((step2.assigned, step2.unassigned))
    assert out[0] == out[1]


@pytest.mark.parametrize("family", ["epigenomics", "blast", "soykb"])
def test_schedule_bit_identical_across_step_modes(family):
    plat = default_cluster()
    wf = generate_workflow(family, 400, seed=3, platform=plat)
    out = set()
    for s1, s2 in (("scalar", "scalar"), ("flat", "flat"), ("scalar", "flat"), ("auto", "auto")):
        set_step1_impl(s1)
        set_step2_impl(s2)
        rep = schedule(wf, plat, kprime=[1, 3, 7])
        out.add((rep.makespan, tuple(rep.summary.block_of_task),
                 tuple(sorted(rep.summary.proc_of_block.items()))))
    assert len(out) == 1


# ---------------------------------------------------- IncrementalEvaluator
def make_platform(k: int = 8, seed: int = 0) -> Platform:
    rng = random.Random(seed)
    procs = [Processor(f"p{i}", rng.choice([1.0, 2.0, 4.0, 8.0]),
                       rng.choice([8.0, 32.0, 192.0])) for i in range(k)]
    return Platform(procs, bandwidth=rng.choice([0.5, 1.0, 2.0]))


def make_quotient(n: int, blocks: int, seed: int) -> QuotientGraph:
    wf = random_layered_dag(n, seed=seed)
    rng = random.Random(seed + 1)
    block_of = [rng.randrange(blocks) for _ in range(n)]
    q = build_quotient(wf, block_of)
    if not q.is_acyclic():          # contiguous blocks by topological position
        pos = {u: i for i, u in enumerate(wf.topological_order())}
        q = build_quotient(wf, [min(blocks - 1, pos[u] * blocks // n) for u in range(n)])
    assert q.is_acyclic()
    return q


def mutate_once(ev, platform, rng) -> None:
    """One random committed mutation: a merge (a 2-cycle escalated to a
    triple merge, a longer one rolled back), a reassignment or a swap."""
    q = ev.q
    verts = sorted(q.members)
    op = rng.random()
    if op < 0.45 and len(verts) >= 2:
        v = rng.choice(verts)
        nbrs = sorted(set(q.pred[v]) | set(q.succ[v]))
        if not nbrs:
            return
        ev.begin()
        vm, cycle = ev.merge(v, rng.choice(nbrs))
        if cycle is not None and len(cycle) == 2:
            vm, cycle = ev.merge(vm, cycle[0] if cycle[0] != vm else cycle[1])
        if cycle is not None:
            ev.rollback()
            return
        ev.commit()
        if rng.random() < 0.7:
            ev.set_proc(vm, rng.randrange(platform.k))
    elif op < 0.75:
        ev.set_proc(rng.choice(verts), rng.choice([None] + list(range(platform.k))))
    elif len(verts) >= 2:
        ev.swap(*rng.sample(verts, 2))


def test_incremental_matches_full_recompute_over_mutations():
    """>= 200 random mutations: the maintained bottom weights, makespan
    and critical path equal a sweep from scratch."""
    mutations = 0
    for seed in range(70):
        platform = make_platform(k=6, seed=seed)
        q = make_quotient(30 + seed % 17, 6 + seed % 5, seed)
        ev = IncrementalEvaluator(q, platform)
        ev.assert_consistent()
        rng = random.Random(1000 + seed)
        for _ in range(3):
            mutate_once(ev, platform, rng)
            mutations += 1
            ev.assert_consistent()
            assert ev.l == bottom_weights(q, platform)
            assert ev.makespan() == makespan(q, platform)
            if all(q.proc[v] is not None for v in q.members):
                assert ev.critical_path() == critical_path(q, platform)
    assert mutations >= 200


def test_incremental_rollback_restores_exact_state():
    platform = make_platform(k=5, seed=3)
    q = make_quotient(40, 8, 3)
    ev = IncrementalEvaluator(q, platform)
    before = (dict(ev.l), {v: dict(q.succ[v]) for v in q.members}, dict(q.proc), dict(ev._rank))
    rng = random.Random(7)
    verts = sorted(q.members)
    for _ in range(20):
        v = rng.choice(verts)
        nbrs = sorted(set(q.pred[v]) | set(q.succ[v]))
        ev.begin()
        ev.set_proc(v, rng.randrange(platform.k))
        if nbrs:
            ev.merge(v, rng.choice(nbrs))
        ev.rollback()
        assert (dict(ev.l), {x: dict(q.succ[x]) for x in q.members}, dict(q.proc),
                dict(ev._rank)) == before
    ev.assert_consistent()


def test_incremental_ranks_stay_topological():
    checked = 0
    for seed in range(25):
        platform = make_platform(k=6, seed=seed)
        q = make_quotient(36 + seed % 13, 7 + seed % 4, seed)
        ev = IncrementalEvaluator(q, platform)
        rng = random.Random(seed * 13 + 5)
        for _ in range(12):
            mutate_once(ev, platform, rng)
            if ev._ranks_exact:
                ranks = {v: ev._rank[v] for v in q.members}
                assert len(set(ranks.values())) == len(ranks)
                assert all(ranks[u] < ranks[w] for u in q.members for w in q.succ[u])
                checked += 1
    assert checked >= 150


def test_swap_probe_cache_on_off_bit_identical():
    for seed in range(20):
        outcomes = []
        for use_cache in (False, True):
            platform = make_platform(k=6, seed=seed)
            q = make_quotient(30 + seed % 11, 6 + seed % 4, seed)
            rng = random.Random(seed)
            for v in sorted(q.members):
                q.proc[v] = rng.randrange(platform.k)
            ev = IncrementalEvaluator(q, platform)
            _swap_pass(q.wf, platform, q, _Requirements(q.wf, 0), ev, probe_cache=use_cache)
            outcomes.append((ev.makespan(), dict(q.proc)))
        assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------- Platform
def _platform(k=8):
    return Platform([Processor(f"p{i}", float(2 + i), float(10 + 4 * i)) for i in range(k)],
                    bandwidth=1.0, name="prop",
                    link_bandwidth={(0, 1): 0.5, (1, 0): 0.5, (2, 5): 3.0},
                    failure_rates={0: 1e-3, 3: 5e-4, 5: 2e-3},
                    power={1: ProcPower(0.5, 2.0), 5: ProcPower(1.0, 3.0, 2.5)})


def _signature(plat):
    """Processors, links, failure and power models by processor name."""
    name = [p.name for p in plat.procs]
    return ({p.name: (p.speed, p.memory) for p in plat.procs},
            {(name[a], name[b]): bw for (a, b), bw in plat.link_bandwidth.items()},
            plat.bandwidth,
            {name[j]: lam for j, lam in plat.failure_rates.items()},
            {name[j]: pw.to_list() for j, pw in plat.power.items()})


def test_platform_transforms_carry_and_reindex_models():
    plat = _platform()
    cur = plat.with_processors([Processor("new0", 3.0, 32.0)]).with_speed(5, 0.5).without({0, 1})
    _, links, _, rates, power = _signature(cur)
    assert rates == {"p3": 5e-4, "p5": 2e-3}
    assert power == {"p5": [1.0, 3.0, 2.5]}
    assert links == {("p2", "p5"): 3.0}
    idx = {p.name: j for j, p in enumerate(cur.procs)}
    assert cur.failure_rate(idx["p3"]) == 5e-4 and cur.failure_rate(idx["p2"]) == 0.0
    assert cur.proc_power(idx["p5"]).busy_watts(1.0) == 4.0 and cur.proc_power(idx["p2"]) is None
    a = plat.with_processors([Processor("x", 1.0, 16.0)]).with_speed(2, 2.0).without({4})
    b = plat.without({4}).with_speed(2, 2.0).with_processors([Processor("x", 1.0, 16.0)])
    assert _signature(a) == _signature(b)
    for failed in ({0}, {1, 5}, {2, 3, 4, 6, 7}):
        kept = {plat.procs[j].name for j in range(plat.k) if j not in failed}
        _, _, _, want_rates, want_power = _signature(plat)
        _, _, _, got_rates, got_power = _signature(plat.without(failed))
        assert got_rates == {n: v for n, v in want_rates.items() if n in kept}
        assert got_power == {n: v for n, v in want_power.items() if n in kept}


def test_platform_queries_and_merge_semantics():
    plat = _platform()
    assert plat.sorted_by_memory() == list(range(7, -1, -1))
    assert (plat.max_memory(), plat.min_memory()) == (38.0, 10.0)
    assert plat.bandwidth_between(0, 1) == 0.5 and plat.bandwidth_between(1, 2) == 1.0
    assert plat.bandwidth_between(3, 3) == float("inf")
    assert plat.has_failure_model and plat.has_power_model
    assert plat.with_failure_rates({1: 9e-9}).failure_rates == {0: 1e-3, 1: 9e-9, 3: 5e-4,
                                                                5: 2e-3}
    assert plat.with_failure_rates({1: 9e-9}, merge=False).failure_rates == {1: 9e-9}
    assert not plat.with_failure_rates({}, merge=False).has_failure_model
    assert plat.with_power({2: ProcPower(1.0, 1.0)}).power[2] == ProcPower(1.0, 1.0)
    assert not plat.with_power({}, merge=False).has_power_model
    with pytest.raises(ValueError):
        plat.with_failure_rates({99: 1e-3})
    with pytest.raises(ValueError):
        plat.with_failure_rates({0: -1.0})
    with pytest.raises(TypeError):
        plat.with_power({0: "not a ProcPower"})


@pytest.mark.parametrize("preset,k,name", [
    (default_cluster, 36, "default"), (small_cluster, 18, "small"), (large_cluster, 60, "large"),
    (more_het_cluster, 36, "MoreHet"), (less_het_cluster, 36, "LessHet"),
    (no_het_cluster, 36, "NoHet")])
def test_paper_cluster_presets(preset, k, name):
    plat = preset(beta=2.0)
    assert (plat.k, plat.name, plat.bandwidth) == (k, name, 2.0)
    assert len({p.name for p in plat.procs}) == k
    kinds = {(p.speed, p.memory) for p in plat.procs}
    assert len(kinds) == (1 if name == "NoHet" else 6)


# ------------------------------------------------- the post-pipeline stages
def _small():
    plat = small_cluster()
    return generate_workflow("blast", 120, seed=2, platform=plat), plat


def _tiny_platform():
    return Platform([Processor("p0", 1.0, 1.0)], 1.0)


@pytest.mark.parametrize("overrides,latency_bound", [
    ({"algorithm": "throughput"}, None),
    ({"algorithm": "throughput"}, 1e-9),
])
def test_stage_of_an_unported_package_raises(overrides, latency_bound):
    """The ``throughput`` stage runs, where it raised while its package was
    missing: the ``throughput`` pipeline's ``ScheduleReport`` is JAX's byte
    for byte (timing aside), with the winner's ``ThroughputPlan`` attached,
    and a latency bound no attempt meets is the reference's structured
    infeasibility."""
    import repro.core as J
    from repro.obs.metrics import METRICS as J_METRICS
    from _torch_parity import untimed_schedule_json

    METRICS.reset()
    J_METRICS.reset()
    opts = {} if latency_bound is None else {"latency_bound": latency_bound}
    wf, plat = _small()
    jplat = J.small_cluster()
    jwf = J.generate_workflow("blast", 120, seed=2, platform=jplat)
    rep = schedule(wf, plat, kprime=[4, 8], throughput_options=opts, **overrides)
    ref = J.schedule(jwf, jplat, kprime=[4, 8], throughput_options=opts, **overrides)
    assert untimed_schedule_json(rep) == untimed_schedule_json(ref)
    if latency_bound is None:
        plan = rep.best.extras["throughput"]
        assert plan.to_dict() == ref.best.extras["throughput"].to_dict()
        assert plan.rate == plan.n_replicas / plan.period
    else:
        assert not rep.feasible and rep.infeasibility.stage == "throughput"


@pytest.mark.parametrize("algorithm", ["dag_het_part", "dag_het_mem"])
def test_simulate_stage_attaches_a_replay(algorithm):
    """``simulate=True`` replays the winner: a contention-free replay
    equal to the analytic makespan to the bit."""
    wf, plat = _small()
    rep = schedule(wf, plat, kprime=[4], algorithm=algorithm, simulate=True)
    assert rep.sim is not None and rep.sim.exact_anchor
    assert rep.sim.makespan == rep.makespan == rep.sim.analytic_makespan


@pytest.mark.parametrize("algorithm,attach", [
    ("reliability", lambda p: p.with_failure_rates({0: 1e-4})),
    ("energy", lambda p: p.with_power({0: ProcPower(1.0, 2.0)})),
])
def test_objective_stages_inert_without_a_model_and_price_with_one(algorithm, attach):
    """Without a failure (power) model the stage returns before it prices
    anything, and the plan is the four-step heuristic's bit for bit; with
    one it attaches its report."""
    wf, plat = _small()
    base = schedule(wf, plat, kprime=[4])
    rep = schedule(wf, plat, kprime=[4], algorithm=algorithm)
    assert rep.makespan == base.makespan
    assert rep.summary.block_of_task == base.summary.block_of_task
    assert rep.summary.proc_of_block == base.summary.proc_of_block
    assert getattr(rep, algorithm) is None
    modeled = schedule(wf, attach(plat), kprime=[4], algorithm=algorithm)
    assert modeled.feasible and getattr(modeled, algorithm) is not None
    assert modeled.makespan == base.makespan


def test_unported_stages_return_first_on_an_infeasible_attempt():
    wf, _ = _small()
    for overrides in ({"simulate": True}, {"algorithm": "throughput"}):
        rep = schedule(wf, _tiny_platform(), kprime=[1], **overrides)
        assert not rep.feasible and rep.infeasibility.stage


def test_memory_trace_replays_after_the_structural_checks():
    wf, plat = _small()
    rep = schedule(wf, plat, kprime=[4])
    assert validate_mapping(wf, rep.best) == []
    assert validate_mapping(wf, rep.best, memory_trace=True) == []
    q = rep.best.quotient
    q.proc[next(iter(q.members))] = None       # unassigned: not simulable
    errors = validate_mapping(wf, rep.best, memory_trace=True)
    assert any("memory trace skipped" in e for e in errors)
