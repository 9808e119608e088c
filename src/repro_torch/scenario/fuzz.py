"""repro_torch.scenario.fuzz — seeded adversarial scenario generation.

The scenario tests check the pause-replan-stitch invariants on
hand-written timelines; this module generates them.  :func:`fuzz_scenarios` draws
random valid workflows, platforms (with random failure-rate/power
models, :mod:`repro_torch.objectives`) and event timelines — failure times
sampled from the platform's own exponential failure rates, plus
arrivals, speed changes, link degrades, and deliberate simultaneous
events in the canonical intra-timestamp order — then drives every
replanning policy and the service loop through them and checks the
*global* invariants:

* every run returns a stitched :class:`TimelineReport` or a
  *structured* infeasibility — never an uncaught exception;
* every feasible timeline validates (:func:`validate_mapping` + memory
  trace, per segment) and survives a JSON round-trip;
* conservation — the last segment's durably completed prefix plus its
  residual equals the submitted work, and the completed prefix never
  shrinks;
* an empty timeline reproduces ``schedule(simulate=True)`` bit-exactly
  (the identity anchor);
* the service loop accounts for every submission
  (completed + infeasible + rejected == submitted).

Everything is a pure function of ``(seed, case index)`` — a corpus is
reproducible from its seed (``REPRO_FUZZ_SEED`` in the test tier,
``python -m repro_torch.scenario.fuzz`` for the large corpus).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from repro_torch.core import Scheduler, SchedulerConfig
from repro_torch.core.platform import Platform, ProcPower, Processor
from repro_torch.core.workflows import generate_workflow

from .events import (
    LinkDegrade,
    PlatformEvent,
    ProcArrival,
    ProcFailure,
    SpeedChange,
    canonical_event_order,
    event_from_dict,
    validate_event_timeline,
)
from .report import TimelineReport
from .runner import Scenario, run_scenario

__all__ = [
    "FUZZ_POLICIES",
    "FuzzCase",
    "FuzzReport",
    "FuzzViolation",
    "fuzz_scenarios",
    "generate_case",
]

FUZZ_POLICIES = ("pinned-warm-start", "full-replan", "no-replan")

_FAMILIES = ("genome", "montage", "seismology", "blast", "epigenomics")


@dataclass(frozen=True)
class FuzzViolation:
    """One broken invariant: which case/policy, which invariant, how."""

    case: int
    seed: int
    policy: str
    invariant: str
    detail: str


@dataclass
class FuzzCase:
    """One generated scenario (pure function of ``(seed, index)``)."""

    index: int
    seed: int
    family: str
    n_tasks: int
    workflow: object
    platform: Platform
    events: list[PlatformEvent]

    @property
    def scenario(self) -> Scenario:
        return Scenario(self.workflow, self.platform, self.events,
                        name=f"fuzz-{self.seed}-{self.index}")


@dataclass
class FuzzReport:
    """Corpus outcome: ``checks`` invariant evaluations across
    ``n_cases`` scenarios; ``violations`` is empty on a clean corpus.
    ``per_policy`` counts violations by policy name (``"service"`` for
    the service-loop runs)."""

    seed: int
    n_cases: int
    checks: int = 0
    violations: list[FuzzViolation] = field(default_factory=list)
    per_policy: dict[str, int] = field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return not self.violations

    def record(self, v: FuzzViolation) -> None:
        self.violations.append(v)
        self.per_policy[v.policy] = self.per_policy.get(v.policy, 0) + 1

    def summary(self) -> str:
        lines = [f"fuzz corpus seed={self.seed}: {self.n_cases} cases, "
                 f"{self.checks} invariant checks, "
                 f"{len(self.violations)} violation(s)"]
        for pol in sorted(set(self.per_policy) | set(FUZZ_POLICIES)
                          | {"service"}):
            lines.append(f"  {pol:>18}: {self.per_policy.get(pol, 0)}")
        for v in self.violations[:20]:
            lines.append(f"  [{v.invariant}] case {v.case} "
                         f"({v.policy}): {v.detail}")
        return "\n".join(lines)


# ---------------------------------------------------------------------- #
# generation
# ---------------------------------------------------------------------- #
def _random_platform(rng: random.Random) -> Platform:
    k = rng.randint(3, 6)
    procs = [Processor(f"fz{j}", rng.choice([0.5, 1.0, 1.0, 2.0]),
                       rng.choice([64.0, 128.0, 256.0]))
             for j in range(k)]
    plat = Platform(procs, bandwidth=rng.choice([0.5, 1.0, 2.0]),
                    name=f"fuzz-k{k}")
    # random failure model on a subset (rates small relative to the
    # horizon so most sampled failure times land inside the run)
    if rng.random() < 0.8:
        rates = {j: rng.uniform(1e-5, 1e-3) for j in range(k)
                 if rng.random() < 0.7}
        if rates:
            plat = plat.with_failure_rates(rates)
    if rng.random() < 0.5:
        plat = plat.with_power(
            {j: ProcPower(rng.uniform(0.1, 2.0), rng.uniform(0.5, 4.0))
             for j in range(k) if rng.random() < 0.8})
    return plat


def _sample_event(rng: random.Random, t: float, plat: Platform,
                  arrivals: int) -> PlatformEvent:
    kinds = ["speed_change", "link_degrade", "proc_arrival"]
    if plat.k > 1:
        kinds += ["proc_failure", "proc_failure"]
    kind = rng.choice(kinds)
    if kind == "proc_failure":
        n_fail = 1 if plat.k <= 2 else rng.choice([1, 1, 2])
        procs = frozenset(rng.sample(range(plat.k),
                                     min(n_fail, plat.k - 1)))
        return ProcFailure(time=t, procs=procs)
    if kind == "proc_arrival":
        return ProcArrival(time=t, procs=(
            Processor(f"fznew{arrivals}", rng.choice([1.0, 2.0]),
                      rng.choice([128.0, 256.0])),))
    if kind == "speed_change":
        return SpeedChange(time=t, proc=rng.randrange(plat.k),
                           factor=rng.choice([0.25, 0.5, 2.0]))
    i = rng.randrange(plat.k)
    j = (i + 1 + rng.randrange(plat.k - 1)) % plat.k if plat.k > 1 else i
    return LinkDegrade(time=t, src=i, dst=j,
                       bandwidth=rng.uniform(0.05, 0.5))


def _sample_timeline(rng: random.Random, plat: Platform,
                     scale: float) -> list[PlatformEvent]:
    """A valid timeline against ``plat``: times from the platform's own
    failure rates where present (rescaled into the run's horizon),
    events applied sequentially so every index is in range at its
    application time, occasional canonical simultaneous pairs."""
    if rng.random() < 0.3:
        return []
    events: list[PlatformEvent] = []
    cur = plat
    arrivals = 0
    t = 0.0
    for _ in range(rng.randint(1, 3)):
        lam_total = sum(cur.failure_rates.values())
        if lam_total > 0 and rng.random() < 0.6:
            # failure-trace draw, folded into the interesting window
            dt = rng.expovariate(lam_total) % (0.4 * scale)
        else:
            dt = rng.uniform(0.05, 0.4) * scale
        t += max(dt, 1e-6)
        ev = _sample_event(rng, t, cur, arrivals)
        events.append(ev)
        if isinstance(ev, ProcArrival):
            arrivals += 1
        cur, _ = ev.apply(cur)
        if rng.random() < 0.25:
            # deliberate tie: identity-map events only, so canonical
            # reordering within the timestamp cannot invalidate indices
            tie = SpeedChange(time=t, proc=rng.randrange(cur.k),
                              factor=rng.choice([0.5, 2.0]))
            events.append(tie)
            cur, _ = tie.apply(cur)
    events = canonical_event_order(events)
    validate_event_timeline(events)
    return events


def generate_case(seed: int, index: int) -> FuzzCase:
    """Deterministically generate fuzz case ``index`` of corpus
    ``seed``: a platform-feasible workflow, a modeled platform, and a
    canonical event timeline."""
    rng = random.Random(f"fuzz:{seed}:{index}")
    plat = _random_platform(rng)
    family = rng.choice(_FAMILIES)
    n_tasks = rng.randint(20, 60)
    wf = generate_workflow(family, n_tasks, seed=rng.randrange(2**31),
                           platform=plat)
    # time scale: total work over total speed lower-bounds the makespan
    scale = wf.total_work() / sum(p.speed for p in plat.procs)
    events = _sample_timeline(rng, plat, max(scale, 1.0))
    return FuzzCase(index=index, seed=seed, family=family, n_tasks=wf.n,
                    workflow=wf, platform=plat, events=events)


# ---------------------------------------------------------------------- #
# invariant checking
# ---------------------------------------------------------------------- #
def _check_timeline(rep: FuzzReport, case: FuzzCase, policy: str,
                    tl: TimelineReport, ref) -> None:
    def bad(invariant: str, detail: str) -> None:
        rep.record(FuzzViolation(case.index, case.seed, policy,
                                 invariant, detail))

    rep.checks += 1
    if not tl.feasible and tl.infeasibility is None:
        bad("structured-infeasibility",
            "infeasible timeline without an Infeasibility record")
    if not tl.feasible:
        return

    rep.checks += 1
    errors = tl.validate(memory_trace=True)
    if errors:
        bad("validate-mapping", "; ".join(errors[:3]))

    rep.checks += 1
    segs = tl.segments
    last = segs[-1]
    if last.completed_before + last.n_tasks != case.workflow.n:
        bad("conservation",
            f"completed {last.completed_before} + residual "
            f"{last.n_tasks} != submitted {case.workflow.n}")
    if any(b.completed_before < a.completed_before
           for a, b in zip(segs, segs[1:])):
        bad("conservation", "durably completed prefix shrank")

    rep.checks += 1
    rt = TimelineReport.from_json(tl.to_json())
    if (rt.makespan != tl.makespan or len(rt.segments) != len(segs)
            or len(rt.migrations) != len(tl.migrations)):
        bad("json-roundtrip", "timeline changed across to_json/from_json")

    if not case.events and ref is not None and ref.sim is not None:
        rep.checks += 1
        if tl.makespan != ref.sim.makespan:
            bad("empty-timeline-anchor",
                f"{tl.makespan!r} != schedule(simulate=True) "
                f"{ref.sim.makespan!r}")


def _check_events_roundtrip(rep: FuzzReport, case: FuzzCase) -> None:
    rep.checks += 1
    rebuilt = [event_from_dict(e.to_dict()) for e in case.events]
    if rebuilt != list(case.events):
        rep.record(FuzzViolation(
            case.index, case.seed, "timeline", "event-roundtrip",
            "events changed across to_dict/event_from_dict"))
        return
    try:
        validate_event_timeline(rebuilt)
    except Exception as exc:  # noqa: BLE001 — fuzz records, not raises
        rep.record(FuzzViolation(
            case.index, case.seed, "timeline", "event-roundtrip",
            f"round-tripped timeline no longer validates: {exc}"))


def _check_service(rep: FuzzReport, case: FuzzCase) -> None:
    from repro_torch.service import Submission, run_service

    rep.checks += 1
    try:
        sr = run_service([Submission(case.workflow, name="fuzz")],
                         case.platform, case.events)
    except Exception as exc:  # noqa: BLE001
        rep.record(FuzzViolation(
            case.index, case.seed, "service", "uncaught-exception",
            f"{type(exc).__name__}: {exc}"))
        return
    jobs = sr.trace.jobs
    terminal = {"completed", "infeasible", "rejected"}
    if len(jobs) != 1 or any(j.status not in terminal for j in jobs):
        rep.record(FuzzViolation(
            case.index, case.seed, "service", "service-conservation",
            f"statuses {[j.status for j in jobs]} don't account for "
            f"the submission"))


def fuzz_scenarios(seed: int = 0, n: int = 25, *,
                   policies=FUZZ_POLICIES, service: bool = True,
                   config: SchedulerConfig | None = None,
                   price_migration: bool = False) -> FuzzReport:
    """Run an ``n``-case fuzz corpus derived from ``seed`` (see module
    docstring for the invariants).  Returns a :class:`FuzzReport`;
    ``report.passed`` is the corpus verdict and ``report.summary()``
    the per-policy violation breakdown.  ``price_migration`` forwards
    to :func:`run_scenario` so the checkpoint-pricing path gets fuzzed
    too."""
    cfg = config if config is not None else SchedulerConfig(simulate=True)
    rep = FuzzReport(seed=seed, n_cases=n)
    for i in range(n):
        case = generate_case(seed, i)
        _check_events_roundtrip(rep, case)
        try:
            ref = Scheduler(cfg).schedule(case.workflow, case.platform)
        except Exception as exc:  # noqa: BLE001
            rep.record(FuzzViolation(i, seed, "initial-plan",
                                     "uncaught-exception",
                                     f"{type(exc).__name__}: {exc}"))
            continue
        for pol in policies:
            try:
                tl = run_scenario(case.scenario, policy=pol, config=cfg,
                                  initial_report=ref,
                                  price_migration=price_migration)
            except Exception as exc:  # noqa: BLE001
                rep.record(FuzzViolation(i, seed, pol,
                                         "uncaught-exception",
                                         f"{type(exc).__name__}: {exc}"))
                continue
            _check_timeline(rep, case, pol, tl, ref)
        if service:
            _check_service(rep, case)
    return rep


def main(argv=None) -> int:
    """CLI (``python -m repro_torch.scenario.fuzz``): run a corpus, print the per-policy
    violation breakdown, exit non-zero on any violation."""
    import argparse
    import os

    ap = argparse.ArgumentParser(
        description="seeded scenario-fuzzing corpus (repro_torch.scenario.fuzz)")
    ap.add_argument("-n", type=int, default=150,
                    help="corpus size (default 150)")
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("REPRO_FUZZ_SEED", "0")),
                    help="corpus seed (default: $REPRO_FUZZ_SEED or 0)")
    ap.add_argument("--price-migration", action="store_true",
                    help="fuzz the checkpoint-pricing replan path too")
    args = ap.parse_args(argv)
    rep = fuzz_scenarios(seed=args.seed, n=args.n,
                         price_migration=args.price_migration)
    print(rep.summary())
    return 0 if rep.passed else 1


if __name__ == "__main__":
    raise SystemExit(main())
