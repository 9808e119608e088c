"""Multi-tenant scheduler-as-a-service on the PyTorch port: quotas, plan
cache, events.  The counterpart of ``examples/multi_tenant_service.py``:
host work only, and it prints what that example prints.

Three tenants share one cluster through `repro_torch.service`.  Alice (a
weight-2 tenant) and Bob submit real scientific pipelines — Alice
resubmits hers, so her repeats hit the plan cache and replay without a
k' sweep; Mallory submits garbage that admission turns into structured
rejections, never exceptions.  Mid-run, two of the big-memory
processors fail (affected jobs freeze their completed prefix and
warm-start replan on what they still own) and a spare node arrives
later (new capacity dispatches waiting jobs, disturbing nobody).

Prints the per-job outcome table, the plan-cache economics, and the
stitched multi-job Gantt with event markers.

Run:  PYTHONPATH=src python examples/multi_tenant_service_torch.py
"""
from repro_torch.core import default_cluster, generate_workflow
from repro_torch.core.platform import Processor
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.scenario import ProcArrival, ProcFailure
from repro_torch.service import (
    QuotaConfig,
    ServiceConfig,
    Submission,
    TenantQuota,
    run_service,
)


def main():
    plat = default_cluster()
    cfg = ServiceConfig(
        scheduler=SchedulerConfig(simulate=True, kprime=[2, 4, 6]),
        quotas=QuotaConfig(tenants={
            "alice": TenantQuota(weight=2.0),
            "bob": TenantQuota(max_running=1),
            "mallory": TenantQuota(max_tasks=500),
        }),
        name="demo")

    mk = lambda fam, n, s: generate_workflow(fam, n, seed=s,
                                             platform=plat)
    subs = [
        # alice's production pipelines, resubmitted (cache hits)
        Submission(mk("montage", 120, 1), tenant="alice",
                   arrival_t=0.0, name="mosaic"),
        Submission(mk("montage", 120, 1), tenant="alice",
                   arrival_t=40.0, name="mosaic"),
        Submission(mk("epigenomics", 100, 2), tenant="alice",
                   arrival_t=80.0, name="methyl"),
        Submission(mk("epigenomics", 100, 2), tenant="alice",
                   arrival_t=120.0, name="methyl"),
        # bob's one-offs
        Submission(mk("seismology", 90, 3), tenant="bob",
                   arrival_t=10.0, name="quake"),
        Submission(mk("blast", 80, 4), tenant="bob",
                   arrival_t=60.0, name="align"),
        # mallory's garbage: structured rejections
        Submission("{definitely not json", tenant="mallory",
                   arrival_t=5.0, name="junk"),
        Submission('{"workflow": {"specification": {"tasks": []}}}',
                   tenant="mallory", arrival_t=15.0, name="hollow"),
    ]
    events = [
        ProcFailure(time=300.0, procs={plat.k - 2, plat.k - 1}),
        ProcArrival(time=900.0,
                    procs=(Processor("spare-0", 2.5, 192.0),)),
    ]

    report = run_service(subs, plat, events, cfg)

    print("=== job outcomes ===")
    hdr = (f"{'job':10s} {'tenant':8s} {'status':10s} {'path':7s} "
           f"{'wait':>8s} {'makespan':>9s} {'replans':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for j in report.jobs:
        wait = f"{j.queue_wait:.0f}" if j.queue_wait is not None else "-"
        span = f"{j.makespan:.0f}" if j.makespan is not None else "-"
        why = ""
        if j.status == "rejected":
            why = f"  [{j.rejection['code']}]"
        print(f"{j.name:10s} {j.tenant:8s} {j.status:10s} "
              f"{j.planning_path or '-':7s} {wait:>8s} {span:>9s} "
              f"{j.n_replans:>7d}{why}")

    print("\n=== plan cache ===")
    cs = report.cache_stats
    print(f"hits={cs.get('service_cache_hits', 0)} "
          f"misses={cs.get('service_cache_misses', 0)} "
          f"stores={cs.get('service_cache_stores', 0)} "
          f"hit_rate={report.cache_hit_rate:.2f}")
    for path, walls in sorted(report.plan_wall_s.items()):
        ms = 1e3 * sum(walls) / len(walls)
        print(f"  {path:7s} planning: {ms:8.1f} ms avg over {len(walls)}")

    print(f"\nutilization: {report.utilization:.1%} of "
          f"{report.trace.n_procs} processors over "
          f"{report.trace.horizon:.0f} time units")
    print("\n=== stitched timeline ===")
    print(report.gantt(width=68))


if __name__ == "__main__":
    main()
