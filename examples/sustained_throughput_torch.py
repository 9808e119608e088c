"""Sustained throughput on the PyTorch port: replicate, pipeline, find the
saturation knee.  The counterpart of ``examples/sustained_throughput.py``:
host work only (``repro_torch.throughput`` and ``repro_torch.service`` are
numpy), and it prints what that example prints.

One genome workflow arrives over and over.  The paper's objective —
one instance's makespan — is the wrong number here; what matters is
instances/s sustained under the latency and memory bounds.  This
walkthrough plans the workflow for steady state with a deliberately
coarse partition (k'=3 leaves the big-memory processors free, so the
whole block group replicates onto a second dominance-matched group and
doubles the rate), checks the identity anchor (one instance at rate→0
reproduces `schedule(..., simulate=True)` bit-exactly), replays a
Poisson stream through `run_sustained` twice (the second run seeds
from the plan cache — no k' sweep), and walks an offered-rate ladder
until the pipeline saturates.

Prints the replication pay-off, the anchor check, per-rate achieved
throughput with latency percentiles, and the plan-cache economics.

Run:  PYTHONPATH=src python examples/sustained_throughput_torch.py
"""
from repro_torch.core import default_cluster, generate_workflow, schedule
from repro_torch.service import PlanCache, run_sustained
from repro_torch.throughput import (
    plan_throughput,
    replicate_plan,
    simulate_pipelined,
)


def main():
    plat = default_cluster()
    wf = generate_workflow("genome", 1000, seed=1, platform=plat)

    # --- steady state: coarse partition + replication ------------- #
    tr = plan_throughput(wf, plat, kprime=[3], workers=1)
    unrep = replicate_plan(tr.best, plat, max_replicas=1)
    print("=== steady-state plan (k'=3) ===")
    print(f"unreplicated: period {unrep.period:9.1f}  "
          f"rate {unrep.rate:.6f} inst/unit")
    print(f"replicated:   period {tr.plan.period:9.1f}  "
          f"rate {tr.plan.rate:.6f} inst/unit  "
          f"({tr.plan.n_replicas} groups, "
          f"{tr.plan.rate / unrep.rate:.2f}x)")
    for gi, g in enumerate(tr.plan.groups):
        names = sorted(plat.procs[p].name for p in g.procs)
        print(f"  group {gi}: {len(names)} procs, "
              f"latency {g.latency:.1f}  ({', '.join(names[:4])}"
              f"{', …' if len(names) > 4 else ''})")

    # --- identity anchor: one instance == the makespan path ------- #
    ref = schedule(wf, plat, kprime=[3], workers=1, simulate=True)
    solo = simulate_pipelined(ref.best, plat, arrivals=[0.0])
    print("\n=== identity anchor (rate→0) ===")
    print(f"schedule(simulate=True) makespan {ref.sim.makespan:.6f}")
    print(f"simulate_pipelined([0.0]) makespan "
          f"{solo.single_makespan:.6f}  "
          f"bit-equal: {solo.single_makespan == ref.sim.makespan}")

    # --- offered-rate ladder through the plan cache --------------- #
    cache = PlanCache()
    print("\n=== offered-rate ladder (32 Poisson arrivals/rung) ===")
    hdr = (f"{'offered':>10s} {'achieved':>10s} {'path':>7s} "
           f"{'p50':>9s} {'p99':>9s} {'sat?':>5s}")
    print(hdr)
    print("-" * len(hdr))
    for frac in (0.3, 0.6, 0.9, 1.1):
        offered = frac * tr.plan.rate
        rep = run_sustained(wf, plat, rate=offered, n_instances=32,
                            seed=1, cache=cache, kprime=[3])
        pct = rep.instance_latency_percentiles
        sat = rep.instances_per_s < 0.95 * offered
        print(f"{offered:10.6f} {rep.instances_per_s:10.6f} "
              f"{rep.jobs[0].planning_path:>7s} "
              f"{pct['p50']:9.0f} {pct['p99']:9.0f} "
              f"{'yes' if sat else 'no':>5s}")
    print(f"analytic sustainable rate: {tr.plan.rate:.6f} "
          "(the 1.1x rung is past it — latency grows, achieved caps)")

    hits = rep.cache_stats.get("service_cache_hits", 0)
    print(f"\nplan cache: size {len(cache)}, last rung planned "
          f"'{rep.jobs[0].planning_path}' "
          f"({'hit' if hits else 'miss'}: the k' sweep ran only on "
          "the cold rung)")


if __name__ == "__main__":
    main()
