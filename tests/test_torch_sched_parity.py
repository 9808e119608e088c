"""Port parity: the paper's scheduler, ``repro_torch.core`` against ``repro.core``.

The same seeded inputs go through both packages, and the decisions must be
equal: workflows task for task and edge for edge, ``schedule()``'s makespans
under ``==`` (the bar is bit-equality: both keep the reference's numpy
sums), each block's members and processor, the k' sweep trace, the cache
counters, and the ``Infeasibility`` of an instance too large for its
platform.  Over the seven families at n = 200 and 1000 with both
algorithms, the paper's six cluster presets, ``workers`` 1 and 2, the
Step-1/Step-2 dispatch modes, multilevel Step 1 and a warm-start
``Scheduler.resume``; and the JSON both write: the workflow schema and
``ScheduleReport.to_json`` byte for byte, timing fields set aside.
"""
import json
from types import SimpleNamespace

import pytest

import repro.core as J
import repro.core.memdag as J_memdag
import repro.core.partitioner as J_partitioner
import repro.core.workflows as J_workflows
import repro_torch.core as T
import repro_torch.core.memdag as T_memdag
import repro_torch.core.partitioner as T_partitioner
import repro_torch.core.workflows as T_workflows

from _torch_parity import fresh_metrics  # noqa: F401 (fixture)

ALGORITHMS = ("dag_het_part", "dag_het_mem")
JAX = SimpleNamespace(core=J, memdag=J_memdag, partitioner=J_partitioner, workflows=J_workflows)
PORT = SimpleNamespace(core=T, memdag=T_memdag, partitioner=T_partitioner, workflows=T_workflows)
PRESETS = ("default_cluster", "small_cluster", "large_cluster", "more_het_cluster",
           "less_het_cluster", "no_het_cluster")




def _instance(pkg, family, n, seed=1, preset="default_cluster"):
    plat = getattr(pkg.core, preset)()
    return pkg.core.generate_workflow(family, n, seed=seed, platform=plat), plat


def _same_workflow(wt, wj):
    assert (wt.n, wt.name, wt.n_edges) == (wj.n, wj.name, wj.n_edges)
    assert list(wt.work) == list(wj.work)
    assert list(wt.mem) == list(wj.mem)
    assert list(wt.persistent) == list(wj.persistent)
    assert list(wt.labels) == list(wj.labels)
    assert [dict(s) for s in wt.succ] == [dict(s) for s in wj.succ]


def _decisions(rep) -> dict:
    """Everything a run decided, no timing: the makespan and the blocks
    (members and processor) of the best mapping, or the infeasibility; the
    sweep trace and the cache counters."""
    out = {"algorithm": rep.algorithm, "feasible": rep.feasible,
           "cache_stats": rep.cache_stats,
           "sweep": [(p.k_prime, p.makespan, p.feasible, p.failed_stage, p.fail_reason,
                      p.memory_gap, p.cache_stats) for p in rep.sweep]}
    if rep.feasible:
        q = rep.best.quotient
        out.update(makespan=rep.makespan, k_used=rep.summary.k_used,
                   k_prime=rep.summary.k_prime, block_of_task=rep.summary.block_of_task,
                   proc_of_block=rep.summary.proc_of_block,
                   blocks=sorted((sorted(q.members[v]), q.proc[v]) for v in q.members))
    else:
        out["infeasibility"] = rep.infeasibility.to_dict()
    return out


def _same_run(rt, rj, counters=True):
    """``counters=False`` sets the cache counters aside: a pool worker's
    Step-2 memo serves only the k' values that worker drew."""
    ours, ref = _decisions(rt), _decisions(rj)
    if not counters:
        for d in (ours, ref):
            d.pop("cache_stats")
            d["sweep"] = [point[:-1] for point in d["sweep"]]
    assert ours == ref
    if rt.feasible:
        assert rt.makespan == rj.makespan       # the bits, not a tolerance


@pytest.mark.parametrize("n", [200, 1000])
@pytest.mark.parametrize("family", J.FAMILIES)
def test_generate_workflow_equal(family, n):
    assert T.FAMILIES == J.FAMILIES
    wt, _ = _instance(PORT, family, n)
    wj, _ = _instance(JAX, family, n)
    _same_workflow(wt, wj)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("n", [200, 1000])
@pytest.mark.parametrize("family", J.FAMILIES)
def test_schedule_equal(family, n, algorithm):
    wt, pt = _instance(PORT, family, n)
    wj, pj = _instance(JAX, family, n)
    rt, rj = T.schedule(wt, pt, algorithm=algorithm), J.schedule(wj, pj, algorithm=algorithm)
    assert rt.feasible
    _same_run(rt, rj)
    assert T.validate_mapping(wt, rt.best) == []


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_infeasibility_equal_on_a_platform_too_small(algorithm):
    reps = []
    for pkg in (PORT, JAX):
        wf, _ = _instance(pkg, "montage", 200)
        tiny = pkg.core.Platform([pkg.core.Processor("p0", 1.0, 1.0),
                                  pkg.core.Processor("p1", 2.0, 2.0)], 1.0)
        reps.append(pkg.core.schedule(wf, tiny, algorithm=algorithm))
    assert not reps[0].feasible and reps[0].infeasibility.stage and reps[0].infeasibility.reason
    _same_run(*reps)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("family", ["bwa", "blast"])
def test_schedule_equal_on_every_paper_preset(family, preset):
    wt, pt = _instance(PORT, family, 200, preset=preset)
    wj, pj = _instance(JAX, family, 200, preset=preset)
    assert [(p.name, p.speed, p.memory) for p in pt.procs] == [
        (p.name, p.speed, p.memory) for p in pj.procs]
    assert (pt.name, pt.bandwidth) == (pj.name, pj.bandwidth)
    _same_workflow(wt, wj)
    for algorithm in ALGORITHMS:
        _same_run(T.schedule(wt, pt, algorithm=algorithm),
                  J.schedule(wj, pj, algorithm=algorithm))


def test_parallel_sweep_equals_serial_and_the_reference():
    wt, pt = _instance(PORT, "blast", 1000)
    wj, pj = _instance(JAX, "blast", 1000)
    parallel = T.schedule(wt, pt, workers=2)
    assert parallel.workers == 2
    _same_run(parallel, J.schedule(wj, pj, workers=1), counters=False)
    _same_run(parallel, J.schedule(wj, pj, workers=2), counters=False)
    _same_run(T.schedule(wt, pt, workers=1), J.schedule(wj, pj, workers=1))


@pytest.mark.parametrize("step1,step2", [("scalar", "scalar"), ("flat", "flat"),
                                         ("scalar", "flat"), ("flat", "scalar")])
def test_schedule_equal_under_each_dispatch_mode(step1, step2):
    prev = [(pkg, pkg.partitioner.set_step1_impl(step1), pkg.memdag.set_step2_impl(step2))
            for pkg in (PORT, JAX)]
    try:
        wt, pt = _instance(PORT, "soykb", 1000, seed=3)
        wj, pj = _instance(JAX, "soykb", 1000, seed=3)
        _same_run(T.schedule(wt, pt, kprime=[1, 3, 7, 12]),
                  J.schedule(wj, pj, kprime=[1, 3, 7, 12]))
    finally:
        for pkg, s1, s2 in prev:
            pkg.partitioner.set_step1_impl(s1)
            pkg.memdag.set_step2_impl(s2)


def test_schedule_equal_with_multilevel_step1():
    wt, pt = _instance(PORT, "blast", 1500)
    wj, pj = _instance(JAX, "blast", 1500)
    rt = T.schedule(wt, pt, kprime=[4, 9], step1_multilevel=True)
    assert rt.cache_stats.get("step1_multilevel_calls", 0) >= 1
    _same_run(rt, J.schedule(wj, pj, kprime=[4, 9], step1_multilevel=True))


def _resume_state(pkg):
    """A warm start after a failure: a fifth of the tasks done (a
    topological prefix), the first block's processor lost, the blocks
    carried over onto the survivors, one block pinned."""
    wf, plat = _instance(pkg, "bwa", 400, seed=5)
    q = pkg.core.schedule(wf, plat, kprime=[4, 9]).best.quotient
    completed = set(wf.topological_order()[: wf.n // 5])
    residual, mapping = pkg.core.residual_workflow(wf, completed)
    back = {old: i for i, old in enumerate(mapping)}
    vids = sorted(q.members)
    lost = q.proc[vids[0]]
    survivors = {old: i for i, old in enumerate(j for j in range(plat.k) if j != lost)}
    blocks, procs = [], []
    for v in vids:
        members = sorted(back[u] for u in q.members[v] if u in back)
        if members:
            blocks.append(members)
            procs.append(survivors.get(q.proc[v]))
    pinned = {next(i for i, p in enumerate(procs) if p is not None)}
    return pkg.core.ResumeState(wf=residual, platform=plat.without({lost}), blocks=blocks,
                                proc_of_block=procs, pinned=pinned)


def test_resume_equal():
    st, sj = _resume_state(PORT), _resume_state(JAX)
    assert (st.blocks, st.proc_of_block, st.pinned) == (sj.blocks, sj.proc_of_block, sj.pinned)
    assert None in st.proc_of_block
    rt = T.Scheduler(T.SchedulerConfig()).resume(st)
    assert rt.feasible and rt.algorithm == "warm_start"
    _same_run(rt, J.Scheduler(J.SchedulerConfig()).resume(sj))


def test_workflow_json_byte_equal_and_read_across():
    wt, pt = _instance(PORT, "epigenomics", 200)
    wj, pj = _instance(JAX, "epigenomics", 200)
    text = J_workflows.to_json(wj)
    assert T_workflows.to_json(wt) == text
    assert T_workflows.to_json(wt, indent=2) == J_workflows.to_json(wj, indent=2)
    back = T_workflows.from_json(text)
    _same_workflow(back, wj)
    _same_run(T.schedule(back, pt), J.schedule(wj, pj))


def _untimed_json(rep) -> str:
    """``rep.to_json()`` with its timing fields set to 0 and the
    plan-latency histogram left out."""
    rep.total_time_s = 0.0
    rep.stage_times = {k: 0.0 for k in rep.stage_times}
    for p in rep.sweep:
        p.time_s = 0.0
        p.stage_times = {k: 0.0 for k in p.stage_times}
        p.metrics.get("histograms", {}).pop("sched_sweep_point_s", None)
    rep.metrics.get("histograms", {}).pop("sched_sweep_point_s", None)
    if rep.summary is not None:
        rep.summary.runtime_s = 0.0
    return rep.to_json()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_schedule_report_json_byte_equal(algorithm):
    wt, pt = _instance(PORT, "seismology", 400)
    wj, pj = _instance(JAX, "seismology", 400)
    rt = T.schedule(wt, pt, algorithm=algorithm, kprime=[2, 5, 11])
    rj = J.schedule(wj, pj, algorithm=algorithm, kprime=[2, 5, 11])
    text = _untimed_json(rj)
    assert _untimed_json(rt) == text
    back = T.ScheduleReport.from_json(text)
    assert back.to_json() == text and back.best is None
    assert back.makespan == rt.makespan
    assert json.loads(text)["summary"]["block_of_task"] == rt.summary.block_of_task
