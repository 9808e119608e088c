"""The port's scheduler-as-a-service, ``repro_torch.service``:
fingerprints, the plan cache, admission and the multi-workflow event loop.

Every case of ``tests/test_service.py`` on the port alone: fingerprints
stable across process restarts (the subprocess with ``jax``, ``jaxlib``
and ``repro`` blocked) and never colliding for same-shape DAGs with
different weights; the single-submission run bit-exactly
``schedule(wf, platform, simulate=True)``; a deterministic trace, also
under ``workers > 1``; and a soak run that conserves jobs.

Then parity with ``repro.service`` on the same seeded inputs, each package
on its own objects (platforms and events cross by value): fingerprint
digests and platform signatures equal; plan-cache files byte-equal, each
package loading the other's; and every service run of the cases above —
quotas, fair share, cache hits, warm replans, failures, arrivals, the soak
— with the ``ServiceTrace`` JSON byte for byte and the ``ServiceReport``
through ``untimed_service_json``, at ``workers`` 1 and 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - container has no hypothesis
    sys.path.insert(0, str(Path(__file__).parent))
    from _hypothesis_fallback import given, settings, st

import repro.core as J
import repro.core.workflows as J_workflows
import repro.scenario as J_scenario
import repro.service as J_service
import repro_torch.core as T
import repro_torch.scenario as T_scenario
import repro_torch.service as T_service
from repro_torch.core import default_cluster
from repro_torch.core.dag import Workflow
from repro_torch.core.platform import Platform, Processor
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.workflows import generate_workflow, to_json
from repro_torch.scenario import (
    EventTimelineError,
    ProcArrival,
    ProcFailure,
    SpeedChange,
    validate_event_timeline,
)
from repro_torch.service import (
    PlanCache,
    QuotaConfig,
    ServiceConfig,
    ServiceReport,
    ServiceTrace,
    Submission,
    TenantQuota,
    WorkflowFingerprint,
    fingerprint_workflow,
    platform_signature,
    run_service,
)

from _torch_parity import (  # noqa: F401 (fixture)
    JAX_BLOCKER,
    events_as,
    fresh_metrics,
    joined_pools,
    platform_as,
    untimed_service_json,
)

_REPO = Path(__file__).resolve().parents[1]
KPRIME = [2, 4]


def _wf(family="montage", n=100, seed=1, plat=None):
    return generate_workflow(family, n, seed=seed,
                             platform=plat or default_cluster())


def _cfg(**kw):
    kw.setdefault("kprime", KPRIME)
    kw.setdefault("simulate", True)
    return SchedulerConfig(**kw)


# ---------------------------------------------------------------------- #
# fingerprints
# ---------------------------------------------------------------------- #
class TestFingerprint:
    def test_deterministic_within_process(self):
        wf = _wf()
        assert (fingerprint_workflow(wf).digest
                == fingerprint_workflow(wf).digest)

    def test_survives_json_round_trip(self):
        wf = _wf()
        wf2 = __import__("repro_torch.core.workflows",
                         fromlist=["from_json"]).from_json(to_json(wf))
        assert (fingerprint_workflow(wf).digest
                == fingerprint_workflow(wf2).digest)

    def test_stable_across_process_restarts(self, tmp_path):
        """The digest must not depend on PYTHONHASHSEED or any other
        per-process state — a restarted service must keep hitting the
        plans its previous life cached.  The subprocess runs with
        ``jax``, ``jaxlib`` and ``repro`` blocked, and its digest is the
        reference's too."""
        wf = _wf(n=60)
        here = fingerprint_workflow(wf).digest
        assert here == J_service.fingerprint_workflow(
            J_workflows.from_json(to_json(wf))).digest
        blocker = tmp_path / "blocker"
        blocker.mkdir()
        (blocker / "sitecustomize.py").write_text(JAX_BLOCKER)
        script = (
            "from repro_torch.core.workflows import from_json\n"
            "from repro_torch.service import fingerprint_workflow\n"
            f"wf = from_json({to_json(wf)!r})\n"
            "print(fingerprint_workflow(wf).digest)\n"
        )
        path = os.pathsep.join([str(blocker), str(_REPO / "src")])
        for seed in ("0", "12345"):
            out = subprocess.run(
                [sys.executable, "-c", script], capture_output=True,
                text=True, check=True,
                env={"PYTHONHASHSEED": seed, "PATH": "/usr/bin:/bin",
                     "PYTHONPATH": path,
                     "REPRO_TEST_BLOCKED": "jax,jaxlib,repro"},
            )
            assert out.stdout.strip() == here

    def test_weight_change_changes_digest(self):
        wf = _wf(n=60)
        d0 = fingerprint_workflow(wf).digest
        wf.work[3] += 1.0
        wf._flat_cache = None
        assert fingerprint_workflow(wf).digest != d0

    def test_edge_cost_change_changes_digest(self):
        wf = _wf(n=60)
        d0 = fingerprint_workflow(wf).digest
        u = next(u for u in range(wf.n) if wf.succ[u])
        v = next(iter(wf.succ[u]))
        wf.succ[u][v] += 0.5
        wf.pred[v][u] += 0.5
        wf._flat_cache = None
        assert fingerprint_workflow(wf).digest != d0

    def test_round_trips_as_dict(self):
        fp = fingerprint_workflow(_wf(n=60))
        fp2 = WorkflowFingerprint.from_dict(
            json.loads(json.dumps(fp.to_dict())))
        assert fp2 == fp

    @given(st.integers(min_value=0, max_value=10_000),
           st.integers(min_value=0, max_value=59),
           st.floats(min_value=0.001, max_value=1000.0))
    @settings(max_examples=25, deadline=None)
    def test_no_false_hits_property(self, seed, task, bump):
        """Same shape, different weights ⇒ different digest.  A false
        *miss* only costs a cold plan; a false *hit* would replay the
        wrong partition — so perturbations must always separate."""
        wf = _wf(n=60, seed=2)
        task = task % wf.n          # families land near, not at, n
        d0 = fingerprint_workflow(wf).digest
        which = seed % 3
        if which == 0:
            wf.work[task] += bump
        elif which == 1:
            wf.mem[task] += bump
        else:
            u = next(u for u in range(wf.n) if wf.succ[u])
            v = next(iter(wf.succ[u]))
            wf.succ[u][v] += bump
            wf.pred[v][u] += bump
        wf._flat_cache = None
        assert fingerprint_workflow(wf).digest != d0

    def test_platform_signature_ignores_name(self):
        plat = default_cluster()
        renamed = Platform(list(plat.procs), plat.bandwidth, "other",
                           dict(plat.link_bandwidth))
        assert platform_signature(plat) == platform_signature(renamed)
        slower = plat.with_speed(0, plat.speed(0) * 0.5)
        assert platform_signature(plat) != platform_signature(slower)


# ---------------------------------------------------------------------- #
# plan cache
# ---------------------------------------------------------------------- #
class TestPlanCache:
    def test_lru_eviction(self):
        cache = PlanCache(capacity=2)
        plat = default_cluster()
        fps = [fingerprint_workflow(_wf(n=30, seed=s)) for s in range(3)]
        keys = [PlanCache.key(fp, plat) for fp in fps]
        for k in keys:
            cache.put(k, [0] * 30, 2, 1.0)
        assert len(cache) == 2
        assert cache.get(keys[0]) is None       # evicted
        assert cache.get(keys[2]) is not None
        assert cache.stats()["evictions"] == 1

    def test_key_separates_platforms(self):
        fp = fingerprint_workflow(_wf(n=30))
        plat = default_cluster()
        degraded = plat.without({0})
        assert PlanCache.key(fp, plat) != PlanCache.key(fp, degraded)


# ---------------------------------------------------------------------- #
# event-timeline validation (satellite: Scenario build-time checks)
# ---------------------------------------------------------------------- #
class TestTimelineValidation:
    def test_unsorted_rejected(self):
        evs = [SpeedChange(time=5.0, proc=0, factor=0.5),
               ProcFailure(time=1.0, procs={1})]
        with pytest.raises(EventTimelineError) as ei:
            validate_event_timeline(evs)
        assert ei.value.code == "unsorted"
        assert ei.value.index == 1

    def test_bad_type_rejected(self):
        with pytest.raises(EventTimelineError) as ei:
            validate_event_timeline(["not an event"])
        assert ei.value.code == "bad-type"

    def test_scenario_constructor_validates(self):
        from repro_torch.scenario import Scenario
        wf = _wf(n=30)
        evs = [SpeedChange(time=5.0, proc=0, factor=0.5),
               ProcFailure(time=1.0, procs={1})]
        with pytest.raises(EventTimelineError):
            Scenario(wf, default_cluster(), evs)

    def test_service_validates(self):
        wf = _wf(n=30)
        evs = [SpeedChange(time=5.0, proc=0, factor=0.5),
               ProcFailure(time=1.0, procs={1})]
        with pytest.raises(EventTimelineError):
            run_service([Submission(wf)], default_cluster(), evs)

    def test_nonfinite_event_time_rejected(self):
        with pytest.raises(ValueError):
            SpeedChange(time=float("nan"), proc=0, factor=0.5)
        with pytest.raises(ValueError):
            SpeedChange(time=float("inf"), proc=0, factor=0.5)


# ---------------------------------------------------------------------- #
# the service loop
# ---------------------------------------------------------------------- #
class TestServiceLoop:
    def test_identity_anchor(self):
        """One submission at t=0, no events, empty quotas ⇒ bit-exactly
        the plain scheduler call."""
        plat = default_cluster()
        wf = _wf(n=120, seed=3)
        cfg = _cfg()
        ref = Scheduler(cfg).schedule(wf, plat)
        rep = run_service([Submission(wf)], plat,
                          config=ServiceConfig(scheduler=cfg))
        (job,) = rep.jobs
        assert job.status == "completed"
        assert job.planning_path == "cold"
        assert job.queue_wait == 0.0
        assert job.makespan == ref.sim.makespan
        ref_map = ref.summary.to_dict()
        ref_map["runtime_s"] = 0.0
        assert job.mapping == ref_map

    def test_cache_hit_on_repeat(self):
        plat = default_cluster()
        wf = _wf(n=100, seed=5)
        rep = run_service(
            [Submission(wf, name="a"),
             Submission(wf, name="b", arrival_t=1e6)],
            plat, config=ServiceConfig(scheduler=_cfg()))
        a, b = rep.jobs
        assert a.planning_path == "cold"
        assert b.planning_path == "seeded"
        assert rep.cache_stats["service_cache_hits"] == 1
        assert rep.cache_stats["service_cache_stores"] >= 1
        assert rep.cache_hit_rate == 0.5
        # the seeded replay must not cost makespan (same platform,
        # same partition, Steps 2-4 re-run: tiny fp drift tolerated)
        assert b.makespan == pytest.approx(a.makespan, rel=1e-9)

    def test_cache_disabled(self):
        plat = default_cluster()
        wf = _wf(n=80, seed=5)
        rep = run_service(
            [Submission(wf, name="a"),
             Submission(wf, name="b", arrival_t=1e6)],
            plat, config=ServiceConfig(scheduler=_cfg(),
                                       plan_cache=False))
        assert [j.planning_path for j in rep.jobs] == ["cold", "cold"]
        assert rep.cache_hit_rate is None

    def test_external_cache_shared_across_runs(self):
        plat = default_cluster()
        wf = _wf(n=80, seed=6)
        cache = PlanCache()
        cfg = ServiceConfig(scheduler=_cfg())
        r1 = run_service([Submission(wf)], plat, config=cfg, cache=cache)
        r2 = run_service([Submission(wf)], plat, config=cfg, cache=cache)
        assert r1.jobs[0].planning_path == "cold"
        assert r2.jobs[0].planning_path == "seeded"

    def test_cache_persists_fingerprint_keyed(self, tmp_path):
        """save → load round-trips every entry under its fingerprint
        key, and a loaded cache seeds a fresh service run."""
        plat = default_cluster()
        wf = _wf(n=80, seed=6)
        cache = PlanCache()
        cfg = ServiceConfig(scheduler=_cfg())
        run_service([Submission(wf)], plat, config=cfg, cache=cache)
        path = tmp_path / "plans.json"
        cache.save(path)

        loaded = PlanCache.load(path)
        assert len(loaded) == len(cache) == 1
        from repro_torch.service import fingerprint_workflow

        key = PlanCache.key(fingerprint_workflow(wf), plat)
        orig, back = cache._store[key], loaded._store[key]
        assert back.block_of_task == orig.block_of_task
        assert back.k_prime == orig.k_prime
        assert back.makespan == orig.makespan
        # the restart path: a brand-new service seeded from disk
        r = run_service([Submission(wf)], plat, config=cfg,
                        cache=loaded)
        assert r.jobs[0].planning_path == "seeded"

    def test_cache_load_capacity_override_evicts_lru(self, tmp_path):
        cache = PlanCache()
        for i in range(3):
            cache.put(f"k{i}", [0], 1, float(i))
        path = tmp_path / "plans.json"
        cache.save(path)
        small = PlanCache.load(path, capacity=2)
        assert len(small) == 2
        assert "k0" not in small._store  # least recent evicted
        assert {"k1", "k2"} <= set(small._store)
        with pytest.raises(ValueError):
            path.write_text(json.dumps({"version": 99, "entries": []}))
            PlanCache.load(path)

    def test_malformed_payload_rejected_not_raised(self):
        rep = run_service(
            [Submission('{"broken": true}', name="bad"),
             Submission("not json at all", name="worse"),
             Submission({"specification": {"tasks": []}}, name="empty")],
            default_cluster(), config=ServiceConfig(scheduler=_cfg()))
        assert all(j.status == "rejected" for j in rep.jobs)
        assert all(j.rejection["code"] == "malformed" for j in rep.jobs)

    def test_quota_rejections(self):
        plat = default_cluster()
        wf = _wf(n=100, seed=2)
        quotas = QuotaConfig(tenants={
            "small": TenantQuota(max_tasks=50),
            "narrow": TenantQuota(max_pending=1),
        })
        rep = run_service(
            [Submission(wf, tenant="small", name="too-big"),
             Submission(wf, tenant="narrow", name="first"),
             Submission(wf, tenant="narrow", name="second"),
             Submission(wf, tenant="narrow", name="third")],
            plat, config=ServiceConfig(scheduler=_cfg(), quotas=quotas))
        by_name = {j.name: j for j in rep.jobs}
        assert by_name["too-big"].status == "rejected"
        assert by_name["too-big"].rejection["code"] == "size-quota"
        # first dispatches immediately (leaves the queue), second waits
        # in the single pending slot, third overflows it
        assert by_name["first"].status == "completed"
        assert by_name["second"].status == "completed"
        assert by_name["third"].status == "rejected"
        assert by_name["third"].rejection["code"] == "queue-quota"

    def test_fair_share_weights(self):
        """With everything arriving at once and capacity for one job at
        a time, a weight-2 tenant drains ~2x the work per turn."""
        plat = default_cluster()
        wf = _wf(n=100, seed=2)
        quotas = QuotaConfig(tenants={"heavy": TenantQuota(weight=2.0)})
        subs = []
        for i in range(2):
            subs.append(Submission(wf, tenant="heavy", name=f"h{i}"))
            subs.append(Submission(wf, tenant="light", name=f"l{i}"))
        rep = run_service(subs, plat,
                          config=ServiceConfig(scheduler=_cfg(),
                                               quotas=quotas))
        assert all(j.status == "completed" for j in rep.jobs)
        h = [j for j in rep.jobs if j.tenant == "heavy"]
        l = [j for j in rep.jobs if j.tenant == "light"]
        # the heavy tenant's backlog never waits longer than light's
        assert max(j.dispatch_t for j in h) <= max(j.dispatch_t
                                                   for j in l)

    def test_warm_replan_on_owned_slowdown(self):
        plat = default_cluster()
        cfg = _cfg(kprime=[4])
        wf = _wf(n=150, seed=7)
        base = run_service([Submission(wf)], plat,
                           config=ServiceConfig(scheduler=cfg))
        names = set(base.jobs[0].allocation)
        idx = [i for i, p in enumerate(plat.procs) if p.name in names]
        rep = run_service(
            [Submission(wf, name="w")], plat,
            [SpeedChange(time=200.0, proc=idx[0], factor=0.1)],
            ServiceConfig(scheduler=cfg))
        (job,) = rep.jobs
        assert job.status == "completed"
        assert job.n_replans == 1
        replans = [e for e in rep.trace.log if e["kind"] == "replan"]
        assert replans and replans[0]["path"] == "warm"
        # a 10x slowdown on an owned processor must cost makespan
        assert job.finish_t > base.jobs[0].finish_t

    def test_proc_arrival_disturbs_nobody(self):
        plat = default_cluster()
        wf = _wf(n=120, seed=3)
        cfg = ServiceConfig(scheduler=_cfg())
        base = run_service([Submission(wf)], plat, config=cfg)
        rep = run_service(
            [Submission(wf)], plat,
            [ProcArrival(time=100.0,
                         procs=(Processor("new-0", 2.0, 64.0),))],
            cfg)
        assert rep.jobs[0].n_replans == 0
        assert rep.jobs[0].finish_t == base.jobs[0].finish_t

    def test_trace_deterministic_and_round_trips(self):
        plat = default_cluster()
        wfs = [_wf(f, 90, s) for s, f in
               enumerate(["montage", "epigenomics"])]
        subs = [Submission(wfs[0], tenant="a", name="m"),
                Submission(wfs[1], tenant="b", arrival_t=10.0, name="e"),
                Submission("garbage", tenant="c", arrival_t=5.0,
                           name="x")]
        events = [ProcFailure(time=250.0, procs={0, 1})]
        cfg = ServiceConfig(scheduler=_cfg())
        r1 = run_service(subs, plat, events, cfg)
        r2 = run_service(subs, plat, events, cfg)
        assert r1.trace.to_json() == r2.trace.to_json()
        rt = ServiceTrace.from_json(r1.trace.to_json())
        assert rt.to_json() == r1.trace.to_json()
        rr = ServiceReport.from_json(r1.to_json())
        assert rr.trace.to_json() == r1.trace.to_json()

    def test_trace_deterministic_with_workers(self):
        """The parallel k' sweep must not leak nondeterminism into the
        service trace."""
        plat = default_cluster()
        wf = _wf(n=100, seed=4)
        subs = [Submission(wf, name="a"),
                Submission(wf, name="b", arrival_t=50.0)]
        serial = run_service(
            subs, plat,
            config=ServiceConfig(scheduler=_cfg(workers=1)))
        parallel = run_service(
            subs, plat,
            config=ServiceConfig(scheduler=_cfg(workers=2)))
        assert serial.trace.to_json() == parallel.trace.to_json()

    def test_soak_conservation(self):
        """Every submission ends in exactly one terminal state, and the
        terminal counters agree with the trace — across a mixed barrage
        of valid jobs, malformed payloads, quota violations, failures
        and arrivals."""
        plat = default_cluster()
        cfg = _cfg()
        fams = ["montage", "epigenomics", "seismology", "blast"]
        subs = []
        for i in range(10):
            if i % 5 == 4:
                subs.append(Submission('{"oops": %d}' % i,
                                       tenant="mal",
                                       arrival_t=7.0 * i,
                                       name=f"bad{i}"))
            else:
                wf = _wf(fams[i % len(fams)], 60 + 10 * (i % 3), i)
                subs.append(Submission(wf, tenant=f"t{i % 3}",
                                       arrival_t=7.0 * i,
                                       name=f"job{i}"))
        events = [ProcFailure(time=150.0, procs={2, 3}),
                  SpeedChange(time=400.0, proc=0, factor=0.5),
                  ProcArrival(time=800.0,
                              procs=(Processor("spare-0", 2.5, 128.0),))]
        quotas = QuotaConfig(
            tenants={"t0": TenantQuota(max_running=1)},
            default=TenantQuota())
        rep = run_service(subs, plat, events,
                          ServiceConfig(scheduler=cfg, quotas=quotas))
        assert len(rep.jobs) == len(subs)
        terminal = {"completed", "infeasible", "rejected"}
        for j in rep.jobs:
            assert j.status in terminal
            if j.status == "completed":
                assert j.finish_t is not None
                assert j.makespan is not None and j.makespan > 0
                assert j.latency >= j.queue_wait >= 0
            elif j.status == "infeasible":
                assert j.infeasibility is not None
            else:
                assert j.rejection is not None
        tallies = rep.cache_stats
        assert (tallies.get("service_completions", 0)
                == len(rep.completed))
        assert (tallies.get("service_rejections", 0)
                == len(rep.rejected))
        assert (tallies.get("service_infeasible", 0)
                == len(rep.infeasible))
        assert (tallies.get("service_admissions", 0)
                == len(rep.jobs) - len(rep.rejected))
        # determinism holds for the whole soak
        rep2 = run_service(subs, plat, events,
                           ServiceConfig(scheduler=cfg, quotas=quotas))
        assert rep.trace.to_json() == rep2.trace.to_json()

    def test_terminal_infeasibility_is_structured(self):
        """A workflow whose biggest task exceeds every processor memory
        is terminally infeasible — a structured outcome, not a crash."""
        plat = default_cluster()
        wf = Workflow(name="huge")
        a, b = wf.add_task(work=10.0, mem=1e9), wf.add_task(work=5.0,
                                                            mem=4.0)
        wf.add_edge(a, b, 1.0)
        rep = run_service([Submission(wf)], plat,
                          config=ServiceConfig(scheduler=_cfg()))
        (job,) = rep.jobs
        assert job.status == "infeasible"
        assert job.infeasibility["reason"]

    def test_gantt_renders(self):
        plat = default_cluster()
        wf = _wf(n=80, seed=9)
        rep = run_service(
            [Submission(wf, name="a"),
             Submission("junk", name="z", arrival_t=1.0)],
            plat, config=ServiceConfig(scheduler=_cfg()))
        art = rep.gantt()
        assert "a#0" in art and "rejected" in art
        assert "█" in art

    def test_utilization_timeline(self):
        plat = default_cluster()
        wf = _wf(n=80, seed=9)
        rep = run_service([Submission(wf)], plat,
                          config=ServiceConfig(scheduler=_cfg()))
        assert rep.utilization is not None and 0 < rep.utilization <= 1
        assert rep.trace.utilization[0][1] > 0     # busy at dispatch
        assert rep.trace.utilization[-1][1] == 0   # idle at the end


# ---------------------------------------------------------------------- #
# parity with repro.service: the same seeded inputs, each package on its
# own objects, compared under == or byte for byte
# ---------------------------------------------------------------------- #
SIDES = {"port": (T, T_scenario, T_service), "jax": (J, J_scenario, J_service)}


def _service_case(side: str, case: str, workers: int = 1):
    """The inputs of one service run, built from ``side``'s package:
    ``(submissions, platform, events, ServiceConfig)``."""
    core, scen, svc = SIDES[side]
    plat = core.default_cluster()

    def wf(family, n, seed):
        return core.generate_workflow(family, n, seed=seed, platform=plat)

    def cfg(quotas=None, **kw):
        kw.setdefault("kprime", KPRIME)
        kw.setdefault("simulate", True)
        kw.setdefault("workers", workers)
        sc = core.SchedulerConfig(**kw)
        return (svc.ServiceConfig(scheduler=sc) if quotas is None
                else svc.ServiceConfig(scheduler=sc, quotas=quotas))

    events = []
    if case == "identity":
        subs = [svc.Submission(wf("montage", 120, 3))]
        config = cfg()
    elif case == "cache-hit":
        w = wf("montage", 100, 5)
        subs = [svc.Submission(w, name="a"),
                svc.Submission(w, name="b", arrival_t=1e6)]
        config = cfg()
    elif case == "malformed":
        subs = [svc.Submission('{"broken": true}', name="bad"),
                svc.Submission("not json at all", name="worse"),
                svc.Submission({"specification": {"tasks": []}}, name="empty")]
        config = cfg()
    elif case == "quotas":
        w = wf("montage", 100, 2)
        quotas = svc.QuotaConfig(tenants={
            "small": svc.TenantQuota(max_tasks=50),
            "narrow": svc.TenantQuota(max_pending=1)})
        subs = [svc.Submission(w, tenant="small", name="too-big")] + [
            svc.Submission(w, tenant="narrow", name=n)
            for n in ("first", "second", "third")]
        config = cfg(quotas)
    elif case == "fair-share":
        w = wf("montage", 100, 2)
        quotas = svc.QuotaConfig(tenants={"heavy": svc.TenantQuota(weight=2.0)})
        subs = []
        for i in range(2):
            subs.append(svc.Submission(w, tenant="heavy", name=f"h{i}"))
            subs.append(svc.Submission(w, tenant="light", name=f"l{i}"))
        config = cfg(quotas)
    elif case == "warm-replan":
        subs = [svc.Submission(wf("montage", 150, 7), name="w")]
        events = [scen.SpeedChange(time=200.0, proc=35, factor=0.1),
                  scen.SpeedChange(time=210.0, proc=30, factor=0.1)]
        config = cfg(kprime=[4])
    elif case == "arrival":
        subs = [svc.Submission(wf("montage", 120, 3))]
        events = [scen.ProcArrival(time=100.0,
                                   procs=(core.Processor("new-0", 2.0, 64.0),))]
        config = cfg()
    elif case == "failure":
        subs = [svc.Submission(wf("montage", 90, 0), tenant="a", name="m"),
                svc.Submission(wf("epigenomics", 90, 1), tenant="b",
                               arrival_t=10.0, name="e"),
                svc.Submission("garbage", tenant="c", arrival_t=5.0, name="x")]
        events = [scen.ProcFailure(time=250.0, procs={0, 1})]
        config = cfg()
    elif case == "soak":
        fams = ["montage", "epigenomics", "seismology", "blast"]
        subs = []
        for i in range(10):
            if i % 5 == 4:
                subs.append(svc.Submission('{"oops": %d}' % i, tenant="mal",
                                           arrival_t=7.0 * i, name=f"bad{i}"))
            else:
                subs.append(svc.Submission(
                    wf(fams[i % len(fams)], 60 + 10 * (i % 3), i),
                    tenant=f"t{i % 3}", arrival_t=7.0 * i, name=f"job{i}"))
        events = [scen.ProcFailure(time=150.0, procs={2, 3}),
                  scen.SpeedChange(time=400.0, proc=0, factor=0.5),
                  scen.ProcArrival(time=800.0,
                                   procs=(core.Processor("spare-0", 2.5, 128.0),))]
        quotas = svc.QuotaConfig(tenants={"t0": svc.TenantQuota(max_running=1)},
                                 default=svc.TenantQuota())
        config = cfg(quotas)
    elif case == "infeasible":
        w = core.Workflow(name="huge")
        a, b = w.add_task(work=10.0, mem=1e9), w.add_task(work=5.0, mem=4.0)
        w.add_edge(a, b, 1.0)
        subs = [svc.Submission(w)]
        config = cfg()
    elif case == "displacement":
        # every processor fails under two running jobs at once: the warm
        # path is gone, and the cold replan finds the platform busy
        subs = [svc.Submission(wf("blast", 80, s), tenant=f"t{s}",
                               arrival_t=float(s), name=f"j{s}")
                for s in range(4)]
        events = [scen.ProcFailure(time=60.0, procs=set(range(0, 36, 2))),
                  scen.ProcArrival(time=400.0, procs=tuple(
                      core.Processor(f"back-{i}", 2.0, 192.0) for i in range(6)))]
        config = cfg()
    else:
        raise ValueError(case)
    return subs, plat, events, config


SERVICE_CASES = ["identity", "cache-hit", "malformed", "quotas", "fair-share",
                 "warm-replan", "arrival", "failure", "soak", "infeasible",
                 "displacement"]


def _run_both(case, workers=1):
    out = []
    for side in ("port", "jax"):
        subs, plat, events, config = _service_case(side, case, workers)
        out.append(SIDES[side][2].run_service(subs, plat, events, config))
    return out


class TestParity:
    @pytest.mark.parametrize("case", SERVICE_CASES)
    def test_service_run_equal(self, case):
        """The trace JSON byte for byte, the report with the wall clock set
        aside, the Gantt text, and the JSON round trip."""
        ours, ref = _run_both(case)
        assert ours.trace.to_json() == ref.trace.to_json()
        assert untimed_service_json(ours) == untimed_service_json(ref)
        assert ours.gantt(width=68) == ref.gantt(width=68)
        assert ours.cache_stats == ref.cache_stats
        assert sorted(ours.plan_wall_s) == sorted(ref.plan_wall_s)
        back = ServiceReport.from_json(ours.to_json())
        assert back.trace.to_json() == ref.trace.to_json()

    @pytest.mark.parametrize("case", ["cache-hit", "failure", "soak"])
    def test_service_run_equal_with_workers(self, case):
        """Under ``workers=2`` the trace is byte-equal to the reference's
        and to the serial run's (the parallel k' sweep decides the same)."""
        ours, ref = _run_both(case, workers=2)
        serial, _ = _run_both(case, workers=1)
        assert ours.trace.to_json() == ref.trace.to_json() == serial.trace.to_json()
        assert ours.plan_wall_s.keys() == ref.plan_wall_s.keys()

    def test_displacement_case_reaches_every_replan_path(self):
        """The displacement case's failure takes a warm replan, a cold
        fallback and a displacement back into the queue: the paths whose
        traces ``test_service_run_equal[displacement]`` holds equal."""
        ours, _ = _run_both("displacement")
        log = [(e["kind"], e.get("path")) for e in ours.trace.log]
        assert ("replan", "warm") in log and ("displaced", None) in log
        assert ours.cache_stats["service_replan_cold_fallbacks"] >= 1
        assert ours.cache_stats["service_displacements"] >= 1
        assert all(j.status == "completed" for j in ours.jobs)

    @pytest.mark.parametrize("family", J.FAMILIES)
    @pytest.mark.parametrize("n", [30, 1000])
    def test_fingerprints_equal(self, family, n):
        plat, jplat = default_cluster(), J.default_cluster()
        wf = generate_workflow(family, n, seed=4, platform=plat)
        jwf = J.generate_workflow(family, n, seed=4, platform=jplat)
        fp, jfp = fingerprint_workflow(wf), J_service.fingerprint_workflow(jwf)
        assert fp.to_dict() == jfp.to_dict()
        assert json.dumps(fp.to_dict()) == json.dumps(jfp.to_dict())
        assert PlanCache.key(fp, plat) == J_service.PlanCache.key(jfp, jplat)

    @pytest.mark.parametrize("preset", ["default_cluster", "small_cluster",
                                        "large_cluster", "more_het_cluster",
                                        "less_het_cluster", "no_het_cluster"])
    def test_platform_signatures_equal(self, preset):
        plat = getattr(T, preset)()
        jplat = platform_as(plat, "jax")
        assert platform_signature(plat) == J_service.platform_signature(jplat)
        # link overrides count, names do not: bridged by value both agree
        linked = plat.with_link_bandwidth(0, 1, 0.25)
        assert platform_signature(linked) != platform_signature(plat)
        assert (platform_signature(linked)
                == J_service.platform_signature(platform_as(linked, "jax")))
        failed = plat.without({0, 3})
        assert (platform_signature(failed)
                == J_service.platform_signature(platform_as(failed, "jax")))

    def test_h100_fleet_signature_equal(self):
        fleet = T.h100_fleet_si({"h100": 4, "h100-degraded": 2})
        assert (platform_signature(fleet)
                == J_service.platform_signature(platform_as(fleet, "jax")))

    def test_plan_cache_files_byte_equal_and_cross_load(self, tmp_path):
        """Each package fills a cache through the same service run; the
        saved files are byte-equal, and each package loads the other's
        file and seeds from it as from its own."""
        caches = {}
        for side in ("port", "jax"):
            subs, plat, events, config = _service_case(side, "soak")
            cache = SIDES[side][2].PlanCache()
            SIDES[side][2].run_service(subs, plat, events, config, cache=cache)
            cache.save(tmp_path / f"{side}.json")
            caches[side] = cache
        ours = (tmp_path / "port.json").read_bytes()
        assert ours == (tmp_path / "jax.json").read_bytes()
        assert caches["port"].stats() == caches["jax"].stats()
        traces = []
        for side, other in (("port", "jax"), ("jax", "port")):
            loaded = SIDES[side][2].PlanCache.load(tmp_path / f"{other}.json")
            loaded.save(tmp_path / f"{side}-again.json")
            assert (tmp_path / f"{side}-again.json").read_bytes() == ours
            subs, plat, events, config = _service_case(side, "soak")
            traces.append(SIDES[side][2].run_service(
                subs, plat, events, config, cache=loaded))
        assert traces[0].trace.to_json() == traces[1].trace.to_json()
        assert any(j.planning_path == "seeded" for j in traces[0].jobs)
        small = PlanCache.load(tmp_path / "jax.json", capacity=2)
        jsmall = J_service.PlanCache.load(tmp_path / "port.json", capacity=2)
        assert list(small._store) == list(jsmall._store)

    @pytest.mark.parametrize("payload", [
        '{"broken": true}', "not json at all", "{definitely not json",
        {"specification": {"tasks": []}},
        '{"workflow": {"specification": {"tasks": []}}}',
    ])
    def test_rejections_equal(self, payload):
        reps = []
        for side in ("port", "jax"):
            core, _, svc = SIDES[side]
            reps.append(svc.run_service([svc.Submission(payload, name="p")],
                                        core.default_cluster()))
        assert reps[0].trace.to_json() == reps[1].trace.to_json()
        assert reps[0].jobs[0].rejection["code"] == "malformed"

    def test_json_payload_resolves_like_the_reference(self):
        """A workflow sent as JSON text resolves to the same DAG in both
        packages: the same fingerprint and the same service trace."""
        plat = default_cluster()
        text = to_json(generate_workflow("seismology", 90, seed=3, platform=plat))
        reps = []
        for side in ("port", "jax"):
            core, _, svc = SIDES[side]
            reps.append(svc.run_service([svc.Submission(text, name="json")],
                                        core.default_cluster(),
                                        config=svc.ServiceConfig(
                                            scheduler=core.SchedulerConfig(kprime=KPRIME))))
        assert reps[0].jobs[0].status == "completed"
        assert reps[0].trace.to_json() == reps[1].trace.to_json()

    def test_events_bridged_by_value_equal(self):
        """Events built once and bridged (``events_as``) give the traces
        the per-side construction gives."""
        subs, plat, events, config = _service_case("port", "soak")
        jsubs, jplat, _, jconfig = _service_case("jax", "soak")
        ours = run_service(subs, plat, events, config)
        ref = J_service.run_service(jsubs, jplat, events_as(events, "jax"), jconfig)
        assert ours.trace.to_json() == ref.trace.to_json()
