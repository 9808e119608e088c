"""The port's observability layer, ``repro_torch.obs``.

Cases of ``tests/test_obs.py`` on the port: the metrics registry
(histograms, snapshot/delta/merge, picklable deltas, the counters facet),
the tracer (nesting, the disabled fast path), the exporters (Chrome trace
schema, JSONL), inertness (bit-equal plans with tracing on and off, the
service loop's trace included), the service report's histogram
percentiles and metric deltas shipped across the ``workers=2`` pool.  The port's registry
is its own object, so the two packages' counters never mix.  Then one
traced ``schedule()`` in each package on the same inputs: the same span
names with the same nesting and attributes (timing aside), and the same
``cache_stats``; and one traced ``run_service()`` in each package: the
same ``service.*`` spans and the same trace.
"""
import json
import pickle

import pytest

import repro.core as J
import repro.obs as J_obs
import repro.service as J_service
from repro.obs.metrics import METRICS as J_METRICS
from repro_torch.core import (
    FAMILIES,
    ScheduleReport,
    counters,
    default_cluster,
    generate_workflow,
    schedule,
)
from repro_torch.obs import (
    METRICS,
    Histogram,
    JsonlSink,
    MetricsRegistry,
    ObsConfig,
    RATIO_BOUNDARIES,
    Span,
    Tracer,
    activate,
    percentile,
    percentiles,
    span_events,
    trace_span,
    tracing_active,
    write_chrome_trace,
)
from repro_torch.service import ServiceConfig, ServiceReport, Submission, run_service


@pytest.fixture(autouse=True)
def _isolate_port_metrics():
    snap = METRICS.snapshot()
    yield
    METRICS.restore(snap)


# ------------------------------------------------------------------ metrics
def test_histogram_buckets_stats_round_trip_and_merge():
    h = Histogram(boundaries=(1.0, 10.0, 100.0))
    for v in (0.5, 1.0, 5.0, 50.0, 500.0):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1]                  # upper edge inclusive
    assert (h.count, h.sum, h.min, h.max) == (5, 556.5, 0.5, 500.0)
    d = h.to_dict()
    assert Histogram.from_dict(d).to_dict() == d
    h2 = Histogram(boundaries=(1.0, 10.0, 100.0))
    h2.observe(5.0)
    h2.merge_dict(d)
    assert (h2.count, h2.min, h2.max) == (6, 0.5, 500.0)


def test_percentiles_clamped_to_observed_range():
    h = Histogram(boundaries=(1.0, 10.0, 100.0))
    for v in (2.0, 3.0, 4.0, 5.0):
        h.observe(v)
    p = percentiles(h.to_dict())
    assert set(p) == {"p50", "p95", "p99"}
    assert all(2.0 <= v <= 5.0 for v in p.values())
    assert p["p50"] <= p["p95"] <= p["p99"]
    assert percentile(h.to_dict(), 0) == pytest.approx(2.0)
    assert percentiles({}) is None


def test_registry_snapshot_delta_merge_and_pickle():
    reg = MetricsRegistry()
    reg.counter("c", 2)
    reg.gauge("g", 1.5)
    reg.observe("h", 0.25)
    snap = reg.snapshot()
    reg.counter("c", 3)
    reg.gauge("g", 2.5)
    reg.observe("h", 0.75)
    d = reg.delta(snap)
    assert d["counters"] == {"c": 3} and d["gauges"] == {"g": 2.5}
    assert d["histograms"]["h"]["count"] == 1
    reg2 = MetricsRegistry()
    reg2.restore(snap)
    reg2.merge(d)
    assert reg2.counters["c"] == 5 and reg2.histograms["h"].count == 2
    ratio = MetricsRegistry()
    ratio.observe("ratio", 1.02, boundaries=RATIO_BOUNDARIES)
    snap = ratio.snapshot()
    ratio.observe("ratio", 1.05, boundaries=RATIO_BOUNDARIES)
    d = ratio.delta(snap)
    assert list(d) == ["histograms"]
    assert pickle.loads(pickle.dumps(d)) == d
    json.loads(json.dumps(d))


def test_counters_feed_the_ports_registry_only():
    assert counters.COUNTERS is METRICS.counters
    assert METRICS is not J_obs.METRICS
    snap, jsnap = METRICS.snapshot(), J_obs.METRICS.snapshot()
    counters.bump("obs_test_counter", 7)
    assert METRICS.delta(snap)["counters"]["obs_test_counter"] == 7
    assert "obs_test_counter" not in J_obs.METRICS.delta(jsnap).get("counters", {})


# ------------------------------------------------------------------- tracer
def test_tracer_nesting_passthrough_and_fast_path():
    tr = Tracer()
    with activate(tr):
        assert tracing_active()
        with trace_span("outer", a=1):
            with activate(None):
                with trace_span("inner") as sp:
                    sp.attrs["b"] = 2
    assert not tracing_active()
    assert [s.name for s in tr.spans] == ["inner", "outer"]    # inner closed first
    by_name = {s.name: s for s in tr.spans}
    assert (by_name["outer"].depth, by_name["inner"].depth) == (0, 1)
    assert by_name["outer"].attrs == {"a": 1} and by_name["inner"].attrs == {"b": 2}
    with trace_span("nope", x=1) as sp:
        sp.attrs["y"] = 2
    assert dict(sp.attrs) == {}
    tr = Tracer()
    tr.extend([Span("a", 0.0, 0.1, "t"), Span("b", 0.0, 0.5, "t"), Span("c", 0.0, 0.3, "t")])
    assert [s.name for s in tr.by_duration(2)] == ["b", "c"]


# ----------------------------------------------------------------- exporters
def _check_chrome_schema(path):
    """Valid JSON, monotone ts, matched B/E pairs per track."""
    events = json.loads(path.read_text())["traceEvents"]
    assert events
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    stacks: dict = {}
    for e in events:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            assert stacks.get(key) and stacks[key].pop() == e["name"]
    assert not any(stacks.values())
    return events


def test_chrome_trace_and_jsonl_sink(tmp_path):
    spans = [Span("run", ts=0.0, dur=1.0, tid="main", depth=0),
             Span("stage", ts=0.2, dur=0.3, tid="main", depth=1, attrs={"k": 4}),
             Span("stage", ts=0.6, dur=0.0, tid="main", depth=1)]
    write_chrome_trace(tmp_path / "trace.json", span_events(spans))
    events = _check_chrome_schema(tmp_path / "trace.json")
    assert len(events) == 6 and {"k": 4} in [e.get("args") for e in events if e["ph"] == "B"]
    with JsonlSink(tmp_path / "events.jsonl") as sink:
        assert sink.enabled
        sink.emit({"a": 1})
        sink.emit({"b": [1, 2]})
    lines = (tmp_path / "events.jsonl").read_text().splitlines()
    assert [json.loads(ln) for ln in lines] == [{"a": 1}, {"b": [1, 2]}]
    disabled = JsonlSink(None)
    disabled.emit({"x": 1})
    assert not disabled.enabled


# ---------------------------------------------------------------- inertness
def _plan(rep):
    s = rep.summary
    return (s.makespan, s.k_used, s.k_prime, tuple(s.block_of_task),
            tuple(sorted(s.proc_of_block.items())))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tracing_is_inert(family, tmp_path):
    plat = default_cluster()
    wf = generate_workflow(family, 1000, seed=11, platform=plat)
    off = schedule(wf, plat, kprime=[4, 9])
    on = schedule(wf, plat, kprime=[4, 9], obs=ObsConfig(
        enabled=True, trace_path=tmp_path / "t.json", sink=tmp_path / "spans.jsonl"))
    assert _plan(off) == _plan(on)
    assert on.spans and not off.spans
    _check_chrome_schema(tmp_path / "t.json")
    logged = [json.loads(ln) for ln in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert len(logged) == len(on.spans) and {r["event"] for r in logged} == {"span"}


def test_probe_spans_are_inert():
    plat = default_cluster()
    wf = generate_workflow("montage", 300, seed=3, platform=plat)
    off = schedule(wf, plat, kprime=[6])
    on = schedule(wf, plat, kprime=[6], obs=ObsConfig(enabled=True, probe_spans=True))
    assert _plan(off) == _plan(on)
    assert any(s.name.startswith("probe.") for s in on.spans)


def test_metric_deltas_and_spans_cross_the_pool():
    plat = default_cluster()
    wf = generate_workflow("blast", 300, seed=7, platform=plat)
    snap = METRICS.snapshot()
    rep = schedule(wf, plat, kprime=[1, 4, 9], workers=2, obs=ObsConfig(enabled=True))
    for p in rep.sweep:
        assert p.metrics["histograms"]["sched_sweep_point_s"]["count"] == 1
    assert METRICS.delta(snap)["histograms"]["sched_sweep_point_s"]["count"] >= len(rep.sweep)
    assert rep.metrics["histograms"]["sched_sweep_point_s"]["count"] == len(rep.sweep)
    assert len({s.tid for s in rep.spans}) >= 2          # the parent and a worker
    back = ScheduleReport.from_json(rep.to_json())
    assert back.metrics == rep.metrics
    d = rep.to_dict()
    del d["metrics"]                                     # a payload without metrics
    for p in d["sweep"]:
        del p["metrics"]
    old = ScheduleReport.from_dict(d)
    assert old.metrics == {} and old.sweep[0].metrics == {}


# ------------------------------------------------- the same spans as JAX's
def _span_tree(spans):
    """Each span's name, depth and attributes, in closing order, with the
    makespan kept and no clock reading."""
    return [(s.name, s.depth, s.tid == spans[-1].tid,
             {k: v for k, v in s.attrs.items() if not k.endswith("_s")}) for s in spans]


@pytest.mark.parametrize("probe_spans", [False, True])
def test_traced_schedule_spans_equal_jax(probe_spans):
    plat, jplat = default_cluster(), J.default_cluster()
    wf = generate_workflow("epigenomics", 400, seed=2, platform=plat)
    jwf = J.generate_workflow("epigenomics", 400, seed=2, platform=jplat)
    rep = schedule(wf, plat, kprime=[3, 9], obs=ObsConfig(enabled=True, probe_spans=probe_spans))
    jrep = J.schedule(jwf, jplat, kprime=[3, 9],
                      obs=J_obs.ObsConfig(enabled=True, probe_spans=probe_spans))
    names = [s.name for s in rep.spans]
    assert names[-1] == "run" and names.count("sweep_point") == 2
    assert {"stage.partition", "stage.assign", "stage.merge", "stage.swap",
            "stage.idle_moves"} <= set(names)
    assert _span_tree(rep.spans) == _span_tree(jrep.spans)
    assert rep.cache_stats == jrep.cache_stats
    assert [p.cache_stats for p in rep.sweep] == [p.cache_stats for p in jrep.sweep]
    assert rep.makespan == jrep.makespan


# ------------------------------------------------------- the service loop
@pytest.fixture
def _fresh_registries():
    """Both registries empty at the start (each package's report lists
    metrics in the order its process first registered them)."""
    METRICS.reset()
    J_METRICS.reset()


def _service_subs(core, service):
    plat = core.default_cluster()
    subs = [
        service.Submission(core.generate_workflow("blast", 120, seed=5, platform=plat),
                           tenant="a", arrival_t=0.0, name="j0"),
        service.Submission(core.generate_workflow("blast", 120, seed=5, platform=plat),
                           tenant="b", arrival_t=1.0, name="j1"),
        service.Submission(core.generate_workflow("genome", 150, seed=6, platform=plat),
                           tenant="a", arrival_t=2.0, name="j2"),
    ]
    return subs, plat


def test_service_trace_bit_identical(tmp_path, _fresh_registries):
    """Tracing the service loop is inert: the virtual-time trace is the
    same bytes with obs on and off, and the reference's; the Chrome trace
    holds both clock domains and the sink streams the log and the spans.
    The spans are the reference's, name, depth and attributes."""
    import repro_torch.core as T
    import repro_torch.service as T_service
    subs, plat = _service_subs(T, T_service)
    off = run_service(subs, plat)
    on = run_service(subs, plat, obs=ObsConfig(
        enabled=True, trace_path=tmp_path / "svc.json", sink=tmp_path / "svc.jsonl"))
    assert on.trace.to_json() == off.trace.to_json()
    assert on.spans and not off.spans
    names = {s.name for s in on.spans}
    assert {"service.admit", "service.dispatch", "service.plan",
            "service.complete"} <= names
    events = _check_chrome_schema(tmp_path / "svc.json")
    assert {"wall", "virtual"} <= {e["pid"] for e in events}
    records = [json.loads(ln) for ln in (tmp_path / "svc.jsonl").read_text().splitlines()]
    assert {r["event"] for r in records} == {"service", "span"}
    assert sum(r["event"] == "service" for r in records) == len(on.trace.log)
    jsubs, jplat = _service_subs(J, J_service)
    ref = J_service.run_service(jsubs, jplat, obs=J_obs.ObsConfig(enabled=True))
    assert on.trace.to_json() == ref.trace.to_json()
    assert _span_tree(on.spans) == _span_tree(ref.spans)


def test_service_percentiles_from_histograms(_fresh_registries):
    plat = default_cluster()
    subs = [Submission(generate_workflow("blast", 120, seed=5, platform=plat),
                       arrival_t=float(i), name=f"j{i}") for i in range(3)]
    rep = run_service(subs, plat)
    p = rep.plan_latency_percentiles
    assert p is not None and p["p50"] <= p["p95"] <= p["p99"]
    assert rep.queue_wait_percentiles is not None
    # identical DAGs: second+ submissions hit the plan cache, so the
    # premium histogram has samples near 1.0
    prem = rep.makespan_premium_percentiles
    assert prem is not None and prem["p50"] >= 0.5
    jplat = J.default_cluster()
    ref = J_service.run_service(
        [J_service.Submission(J.generate_workflow("blast", 120, seed=5, platform=jplat),
                              arrival_t=float(i), name=f"j{i}") for i in range(3)], jplat)
    # the virtual-time histograms are the reference's; the wall clock's is not
    assert rep.queue_wait_percentiles == ref.queue_wait_percentiles
    assert rep.makespan_premium_percentiles == ref.makespan_premium_percentiles
    assert (rep.metrics["histograms"]["service_plan_latency_s"]["count"]
            == ref.metrics["histograms"]["service_plan_latency_s"]["count"])


def test_service_payload_without_metrics_loads():
    """A ``run_service`` payload written without a metrics block loads with
    empty metrics and no percentiles."""
    plat = default_cluster()
    svc = run_service([Submission(generate_workflow("blast", 120, seed=4, platform=plat),
                                  name="j0")], plat)
    sd = svc.to_dict()
    del sd["metrics"]
    old = ServiceReport.from_dict(sd)
    assert old.metrics == {} and old.plan_latency_percentiles is None
    assert old.trace.to_json() == svc.trace.to_json()
