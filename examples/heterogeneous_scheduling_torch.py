"""The paper's experiment, interactively, on the PyTorch port: how
heterogeneity awareness changes the mapping of a memory-constrained
workflow.  The counterpart of ``examples/heterogeneous_scheduling.py``:
host work only (``repro_torch.core`` and ``repro_torch.sim`` are numpy),
and it prints what that example prints.

Walks one workflow through all four DagHetPart steps, printing what
each step did, replays the winning mapping through the discrete-event
simulator (repro_torch.sim: bit-exact paper model, link contention, jitter
envelope, a small Gantt), then sweeps cluster heterogeneity like the
paper's Fig. 4.

Run:  PYTHONPATH=src python examples/heterogeneous_scheduling_torch.py
"""
from repro_torch.core import (
    Scheduler,
    SchedulerConfig,
    bottom_weights,
    default_cluster,
    generate_workflow,
    less_het_cluster,
    more_het_cluster,
    no_het_cluster,
    schedule,
)
from repro_torch.sim import simulate

SWEEP = [1, 4, 9, 19, 36]


def describe_mapping(tag, wf, report, plat):
    if not report.feasible:
        inf = report.infeasibility
        print(f"{tag}: no valid mapping "
              f"(stage '{inf.stage}': {inf.reason})")
        return
    res = report.best
    q = res.quotient
    print(f"{tag}: makespan {res.makespan:.1f} with {q.n_vertices} blocks")
    by_speed = {}
    for vid in q.vertices():
        p = plat.procs[q.proc[vid]]
        kind = p.name.rsplit("-", 1)[0]
        by_speed[kind] = by_speed.get(kind, 0) + len(q.members[vid])
    dist = ", ".join(f"{k}:{v}" for k, v in sorted(by_speed.items()))
    print(f"  tasks per processor kind: {dist}")


def main():
    plat = default_cluster()
    wf = generate_workflow("montage", 300, seed=2, platform=plat)
    print(f"workflow: montage, {wf.n} tasks, {wf.n_edges} edges\n")

    base = schedule(wf, plat, algorithm="dag_het_mem")
    describe_mapping("DagHetMem (memory-only baseline)", wf, base, plat)

    # the sweep reports through the on_sweep_result callback — the one
    # channel shared by verbose mode, benchmarks and the process pool
    print("DagHetPart k' sweep:")
    het = Scheduler(SchedulerConfig(
        kprime=SWEEP,
        on_sweep_result=lambda p: print(
            f"  k'={p.k_prime}: "
            + (f"makespan {p.makespan:.1f}" if p.feasible
               else f"infeasible at stage '{p.failed_stage}'")),
    )).schedule(wf, plat)
    describe_mapping("DagHetPart (heterogeneity-aware)", wf, het, plat)
    print(f"\nimprovement: {base.makespan / het.makespan:.2f}x\n")

    # -------------------------------------------------------------- #
    # execute the plan: the analytic makespan is a proxy, repro_torch.sim
    # replays the schedule event by event
    # -------------------------------------------------------------- #
    print("simulated execution (repro_torch.sim):")
    sim = simulate(het.best)
    print(f"  paper model: makespan {sim.makespan:.1f} "
          f"(bit-identical to analytic: {sim.makespan == het.makespan}; "
          f"memory trace feasible: {sim.memory.feasible})")
    cont = simulate(het.best, comm="fair-share", memory=False)
    print(f"  fair-share link contention: {cont.makespan:.1f} "
          f"({100 * cont.makespan / het.makespan - 100:+.1f}% vs analytic)")
    env = simulate(het.best, jitter=0.2, replicas=16,
                   memory=False, record_events=False).envelope
    print(f"  20% duration jitter (16 replicas): makespan in "
          f"[{env.lo:.1f}, {env.hi:.1f}], mean {env.mean:.1f}")

    small = generate_workflow("montage", 40, seed=2, platform=plat)
    srep = schedule(small, plat, kprime=[4], simulate=True)
    print(f"\nGantt of a 40-task montage mapping "
          f"(simulated makespan {srep.sim.makespan:.1f}):")
    print(srep.sim.gantt(width=60))
    print()

    print("heterogeneity sweep (paper Fig. 4):")
    for name, cl in (("NoHet", no_het_cluster()),
                     ("LessHet", less_het_cluster()),
                     ("default", default_cluster()),
                     ("MoreHet", more_het_cluster())):
        wfc = generate_workflow("montage", 300, seed=2, platform=cl)
        b = schedule(wfc, cl, algorithm="dag_het_mem")
        h = schedule(wfc, cl, kprime=SWEEP)
        if b.feasible and h.feasible:
            print(f"  {name:8s}: relative makespan "
                  f"{100 * h.makespan / b.makespan:5.1f}%")


if __name__ == "__main__":
    main()
