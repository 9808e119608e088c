"""The port's scenario fuzzing, ``repro_torch.scenario.fuzz``: the smoke
corpus, tie ordering, reproducibility.

Every case of ``tests/test_fuzz_scenarios.py`` on the port alone, at the
reference's defaults: the corpus runs every replanning policy and the
service loop's conservation check (``service=True``).  The large corpus is
behind the ``slow`` marker and reproducible via ``REPRO_FUZZ_SEED``.

Then parity with ``repro.scenario.fuzz``: the 25-case corpus, plain and
with checkpoint pricing, gives JAX's ``FuzzReport`` (checks, violations,
per-policy counts and summary), so does the CLI, and each generated case
is JAX's.
"""
import dataclasses
import os

import pytest

import repro.scenario as J_scenario
import repro.scenario.fuzz as J_fuzz
from repro_torch.core import SchedulerConfig
from repro_torch.scenario import (
    EventTimelineError,
    LinkDegrade,
    ProcFailure,
    Scenario,
    SpeedChange,
    canonical_event_order,
    event_from_dict,
    event_sort_key,
    fuzz_scenarios,
    generate_case,
    run_scenario,
    validate_event_timeline,
)
from repro_torch.obs.metrics import METRICS
from repro_torch.scenario.fuzz import FUZZ_POLICIES, main

from _torch_parity import fresh_metrics  # noqa: F401 (fixture)

SMOKE_SEED = 2026


# ---------------------------------------------------------------------- #
# the deterministic smoke corpus
# ---------------------------------------------------------------------- #
class TestSmokeCorpus:
    def test_25_seed_corpus_clean(self, smoke_corpus):
        """Acceptance gate: 25 cases × all policies, zero uncaught
        exceptions, every invariant holds, the service check's
        included."""
        rep = smoke_corpus
        assert rep.passed, rep.summary()
        assert rep.n_cases == 25
        # the corpus exercises every policy
        assert set(FUZZ_POLICIES) == {"pinned-warm-start",
                                      "full-replan", "no-replan"}

    def test_pricing_corpus_clean(self):
        """The checkpoint-pricing path upholds the same invariants."""
        rep = fuzz_scenarios(seed=SMOKE_SEED + 1, n=10,
                             price_migration=True)
        assert rep.passed, rep.summary()

    def test_corpus_is_deterministic(self):
        a = fuzz_scenarios(seed=SMOKE_SEED, n=5)
        b = fuzz_scenarios(seed=SMOKE_SEED, n=5)
        assert a.checks == b.checks
        assert a.violations == b.violations

    def test_cases_are_reproducible(self):
        for i in range(5):
            c1 = generate_case(SMOKE_SEED, i)
            c2 = generate_case(SMOKE_SEED, i)
            assert c1.family == c2.family
            assert c1.n_tasks == c2.n_tasks
            assert list(c1.events) == list(c2.events)
            assert [p.name for p in c1.platform.procs] == \
                [p.name for p in c2.platform.procs]
            assert c1.platform.failure_rates == c2.platform.failure_rates

    def test_corpus_covers_the_interesting_shapes(self):
        """Not vacuous: some cases have empty timelines (the bit-exact
        anchor), some multi-event, some with failure models."""
        cases = [generate_case(SMOKE_SEED, i) for i in range(25)]
        assert any(not c.events for c in cases)
        assert any(len(c.events) >= 2 for c in cases)
        assert any(c.platform.failure_rates for c in cases)
        assert any(
            isinstance(e, ProcFailure) for c in cases for e in c.events)


@pytest.mark.slow
class TestLargeCorpus:
    def test_large_corpus_clean(self):
        seed = int(os.environ.get("REPRO_FUZZ_SEED", "0"))
        rep = fuzz_scenarios(seed=seed, n=150)
        assert rep.passed, rep.summary()

    def test_large_pricing_corpus_clean(self):
        seed = int(os.environ.get("REPRO_FUZZ_SEED", "0"))
        rep = fuzz_scenarios(seed=seed + 7, n=75, price_migration=True)
        assert rep.passed, rep.summary()


# ---------------------------------------------------------------------- #
# intra-timestamp event ordering (the fix the fuzzer depends on)
# ---------------------------------------------------------------------- #
class TestTieOrdering:
    def test_canonical_order_accepted(self):
        evs = [ProcFailure(time=5.0, procs={1}),
               SpeedChange(time=5.0, proc=0, factor=0.5),
               LinkDegrade(time=5.0, src=0, dst=1, bandwidth=0.5)]
        validate_event_timeline(evs)  # does not raise

    def test_non_canonical_tie_rejected(self):
        evs = [SpeedChange(time=5.0, proc=0, factor=0.5),
               ProcFailure(time=5.0, procs={1})]
        with pytest.raises(EventTimelineError) as ei:
            validate_event_timeline(evs)
        assert ei.value.code == "unsorted-tie"
        assert ei.value.index == 1

    def test_same_kind_tiebreak(self):
        a = SpeedChange(time=5.0, proc=0, factor=0.5)
        b = SpeedChange(time=5.0, proc=1, factor=0.5)
        assert event_sort_key(a) < event_sort_key(b)
        validate_event_timeline([a, b])
        with pytest.raises(EventTimelineError):
            validate_event_timeline([b, a])

    def test_equal_events_allowed(self):
        a = SpeedChange(time=5.0, proc=0, factor=0.5)
        validate_event_timeline([a, a])

    def test_canonical_event_order_sorts_into_accepted(self):
        evs = [LinkDegrade(time=5.0, src=0, dst=1, bandwidth=0.5),
               SpeedChange(time=5.0, proc=2, factor=2.0),
               SpeedChange(time=1.0, proc=0, factor=0.5),
               ProcFailure(time=5.0, procs={3})]
        fixed = canonical_event_order(evs)
        validate_event_timeline(fixed)
        assert [e.time for e in fixed] == [1.0, 5.0, 5.0, 5.0]
        assert fixed[1].kind == "proc_failure"

    def test_scenario_rejects_non_canonical_tie(self):
        c = generate_case(SMOKE_SEED, 0)
        evs = [SpeedChange(time=1.0, proc=0, factor=0.5),
               ProcFailure(time=1.0, procs={1})]
        with pytest.raises(EventTimelineError):
            Scenario(c.workflow, c.platform, evs)

    def test_tied_events_replay_identically_from_json(self):
        """A JSON round-trip of simultaneous events cannot reorder them:
        the canonical order pins the replay bit-exactly."""
        c = generate_case(SMOKE_SEED, 3)
        plat = c.platform
        evs = canonical_event_order([
            SpeedChange(time=8.0, proc=0, factor=0.5),
            SpeedChange(time=8.0, proc=1, factor=2.0),
            LinkDegrade(time=8.0, src=0, dst=1, bandwidth=0.25),
        ])
        rebuilt = [event_from_dict(e.to_dict()) for e in evs]
        assert rebuilt == evs
        cfg = SchedulerConfig(simulate=True)
        tl1 = run_scenario(Scenario(c.workflow, plat, evs), config=cfg)
        tl2 = run_scenario(Scenario(c.workflow, plat, rebuilt),
                           config=cfg)
        assert tl1.makespan == tl2.makespan
        assert len(tl1.segments) == len(tl2.segments)


@pytest.fixture(scope="module")
def smoke_corpus():
    """The port's 25-case smoke corpus, run once for the module.  It runs
    before each test's metrics bracket opens, so it restores the port's
    registry itself: a counter it registered first would reorder the
    reports of later tests in the same process."""
    snap = METRICS.snapshot()
    try:
        return fuzz_scenarios(seed=SMOKE_SEED, n=25)
    finally:
        METRICS.restore(snap)


def test_service_check_raises_until_ported(capsys):
    """``service=True`` (the reference's default, and the CLI's) runs the
    service loop's conservation check once per case without raising: the
    corpus's record is the reference's, one check a case more than without
    it, and the CLI's ``-n`` run prints the reference's summary and exits 0."""
    ours = fuzz_scenarios(seed=SMOKE_SEED, n=8, service=True)
    ref = J_scenario.fuzz_scenarios(seed=SMOKE_SEED, n=8, service=True)
    assert _record(ours) == _record(ref)
    assert ours.passed and ours.per_policy.get("service", 0) == 0
    assert ours.checks == fuzz_scenarios(seed=SMOKE_SEED, n=8, service=False).checks + 8
    assert main(["-n", "3"]) == 0
    out = capsys.readouterr().out
    assert J_fuzz.main(["-n", "3"]) == 0
    assert capsys.readouterr().out == out
    assert "service: 0" in out and "0 violation(s)" in out


def _record(rep):
    """Everything a corpus reports: its violations as plain tuples (each
    package has its own ``FuzzViolation``), the counts and the summary."""
    return ([dataclasses.astuple(v) for v in rep.violations], rep.seed, rep.n_cases,
            rep.checks, rep.passed, rep.per_policy, rep.summary())


@pytest.mark.parametrize("price_migration", [False, True])
def test_corpus_equals_the_reference(price_migration, smoke_corpus):
    ours = (smoke_corpus if not price_migration
            else fuzz_scenarios(seed=SMOKE_SEED, n=25, price_migration=True))
    ref = J_scenario.fuzz_scenarios(seed=SMOKE_SEED, n=25,
                                    price_migration=price_migration)
    assert _record(ours) == _record(ref)
    assert ours.checks > 25 * len(FUZZ_POLICIES)


@pytest.mark.parametrize("index", range(25))
def test_generated_case_equals_the_reference(index):
    ours, ref = generate_case(SMOKE_SEED, index), J_scenario.generate_case(SMOKE_SEED, index)
    assert (ours.family, ours.n_tasks) == (ref.family, ref.n_tasks)
    assert [e.to_dict() for e in ours.events] == [e.to_dict() for e in ref.events]
    assert [(p.name, p.speed, p.memory) for p in ours.platform.procs] == [
        (p.name, p.speed, p.memory) for p in ref.platform.procs]
    assert (ours.platform.bandwidth, ours.platform.failure_rates) == (
        ref.platform.bandwidth, ref.platform.failure_rates)
    assert {j: pw.to_list() for j, pw in ours.platform.power.items()} == {
        j: pw.to_list() for j, pw in ref.platform.power.items()}
    assert [dict(s) for s in ours.workflow.succ] == [dict(s) for s in ref.workflow.succ]
    assert list(ours.workflow.work) == list(ref.workflow.work)
    assert list(ours.workflow.mem) == list(ref.workflow.mem)
