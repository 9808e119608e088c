"""The program's spans and counters as the benchmark reads them: device
and idle seconds by span on a synthetic Chrome trace with correlation
ids, nested ranges and an autograd thread; the MoE slot fill from the
program's counters; and a traced run on the CPU, under a real profiler,
that reports it."""
import pytest

from chipbench import harness, spans, trace
from repro_torch.obs.metrics import METRICS

MAIN, AUTOGRAD = 1, 2


@pytest.fixture(autouse=True)
def _isolate_port_metrics():
    snap = METRICS.snapshot()
    yield
    METRICS.restore(snap)


def _x(cat, name, a, b, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr, "External id": 100 + corr}
    return e


# a train step: forward (with one MoE layer) and AdamW on the main thread,
# the backward's launches on the autograd thread, one of them under a
# range that thread opened itself; kernels on two streams (7, 8)
RAW = {"traceEvents": [
    _x("user_annotation", "chipbench.window", 0.0, 1000.0, MAIN),
    _x("user_annotation", "chipbench.train_step", 0.0, 900.0, MAIN),
    _x("user_annotation", "repro_torch.train.forward", 10.0, 300.0, MAIN),
    _x("user_annotation", "repro_torch.moe", 50.0, 250.0, MAIN),
    _x("user_annotation", "repro_torch.moe.experts", 100.0, 200.0, MAIN),
    _x("user_annotation", "repro_torch.train.backward", 300.0, 700.0, MAIN),
    _x("user_annotation", "repro_torch.train.adamw", 700.0, 900.0, MAIN),
    _x("user_annotation", "repro_torch.moe", 400.0, 450.0, AUTOGRAD),
    _x("cuda_runtime", "cudaLaunchKernel", 60.0, 65.0, MAIN, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 110.0, 115.0, MAIN, 2),
    _x("cuda_runtime", "cudaLaunchKernel", 150.0, 155.0, MAIN, 3),
    _x("cuda_runtime", "cudaLaunchKernel", 350.0, 355.0, AUTOGRAD, 4),
    _x("cuda_runtime", "cudaLaunchKernel", 420.0, 425.0, AUTOGRAD, 5),
    _x("cuda_runtime", "cudaMemcpyAsync", 710.0, 715.0, MAIN, 6),
    _x("cuda_runtime", "cudaLaunchKernel", 905.0, 908.0, MAIN, 7),
    _x("kernel", "router_gemm", 70.0, 120.0, 7, 1),
    _x("kernel", "expert_gemm", 120.0, 200.0, 7, 2),
    _x("kernel", "expert_gemm", 150.0, 210.0, 8, 3),         # beside the last
    _x("kernel", "grad_kernel", 360.0, 500.0, 7, 4),
    _x("kernel", "moe_grad_kernel", 500.0, 550.0, 7, 5),
    _x("gpu_memcpy", "Memcpy DtoD", 720.0, 800.0, 7, 6),
    _x("kernel", "loss_kernel", 910.0, 950.0, 7, 7),
    _x("kernel", "no_launch_seen", 960.0, 980.0, 7, 99),
    _x("gpu_user_annotation", "repro_torch.moe", 70.0, 210.0, 7),
    _x("kernel", "after_the_window", 1100.0, 1200.0, 7, 8),
]}


def test_span_and_idle_seconds_are_exact():
    s = spans.summarize_spans(RAW)
    # busy: [70, 210] + [360, 550] + [720, 800] + [910, 950] + [960, 980]
    assert s["busy_s"] == pytest.approx(470e-6)
    got = {name: (v["inclusive"], v["self"], v["ranges"]) for name, v in s["span_s"].items()}
    want = {"repro_torch.train.forward": (140e-6, 0.0, 1),
            "repro_torch.moe": (190e-6, 100e-6, 2),             # forward's and the backward's
            "repro_torch.moe.experts": (90e-6, 90e-6, 1),       # two streams, counted once
            "repro_torch.train.backward": (190e-6, 140e-6, 1),  # the autograd thread's
            "repro_torch.train.adamw": (80e-6, 80e-6, 1)}
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name] == pytest.approx(w), name
    assert s["unattributed_s"] == pytest.approx(60e-6)
    # every span's self time and the unattributed time add up to the union
    assert sum(v["self"] for v in s["span_s"].values()) + s["unattributed_s"] == pytest.approx(
        s["busy_s"])
    idle = s["idle_by_span"]
    assert idle == pytest.approx({"repro_torch.train.forward": 220e-6,
                                  "repro_torch.train.backward": 170e-6,
                                  "repro_torch.train.adamw": 110e-6,
                                  spans.NO_SPAN: 30e-6})
    assert sum(idle.values()) + s["busy_s"] == pytest.approx(1000e-6)


def test_the_busy_union_is_the_benchmark_summarys():
    assert spans.summarize_spans(RAW)["busy_s"] == pytest.approx(
        trace.summarize(trace.read_events(RAW))["busy_s"])


def test_a_trace_without_program_spans_reads_empty():
    raw = {"traceEvents": [e for e in RAW["traceEvents"]
                           if not e["name"].startswith(spans.PROGRAM)]}
    s = spans.summarize_spans(raw)
    assert s["span_s"] == {} and s["unattributed_s"] == pytest.approx(s["busy_s"])
    assert set(s["idle_by_span"]) == {spans.NO_SPAN}


def test_spans_need_the_window():
    with pytest.raises(ValueError):
        spans.summarize_spans({"traceEvents": RAW["traceEvents"][1:]})


def test_slot_fill_reads_the_programs_counters():
    rec = {"kind": "prefill", "model": {"n_layers": 4, "experts_per_token": 2},
           "trace": {"calls": 3, "tokens": 80}}
    assert harness.read_metric("moe_slot_fill.prefill", rec) is None
    METRICS.counter("moe.slots", 800)
    METRICS.counter("moe.pairs_routed", 640)
    METRICS.counter("moe.slots_taken", 600)
    assert harness.read_metric("moe_slot_fill.prefill", rec) == pytest.approx(75.0)
    # a profiled MoE call outside the sub-window: its counts are not the
    # sub-window's, so nothing is read
    METRICS.counter("moe.slots", 200)
    METRICS.counter("moe.pairs_routed", 160)
    assert harness.read_metric("moe_slot_fill.prefill", rec) is None
    # an untraced run and a training run have nothing to read
    assert harness.read_metric("moe_slot_fill.prefill", {"kind": "prefill"}) is None
    assert harness.read_metric("moe_slot_fill.prefill", {**rec, "kind": "train"}) is None


@pytest.mark.parametrize("name", ["moe_slot_fill.prefill"])
def test_nothing_to_read_gives_none(name):
    rec = {"kind": "prefill", "model": {}, "trace": {"calls": 1}}
    assert harness.read_metric(name, rec) is None


class _CpuTracer:
    """The benchmark's tracer on the CPU: a real profiler records the
    sub-window (so the program counts), its trace is the synthetic one."""

    @staticmethod
    def warm():
        pass

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU])
        self._prof.__enter__()

    def stop(self):
        self._prof.__exit__(None, None, None)

    def read(self):
        return trace.read_events(RAW)


def test_a_traced_prefill_reports_the_slot_fill(monkeypatch):
    from chipbench.drivers import prefill_closed
    monkeypatch.setattr(trace, "Tracer", _CpuTracer)
    monkeypatch.setattr(prefill_closed, "Tracer", _CpuTracer)
    smoke = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96,
             "vocab_size": 256, "n_experts": 8, "experts_per_token": 2}
    ctx = harness.make_ctx("olmoe_1b_7b.prefill_4x4k", 2**31 + 11, 0.6, True, device="cpu",
                           config_overrides=smoke, traffic_overrides={"prompt_len": 32})
    out = harness.run_cell(ctx)
    fill = out["metrics"]["moe_slot_fill.prefill"]
    assert fill["unit"] == "%" and 0 < fill["value"] <= 80.0
    counters = METRICS.snapshot()["counters"]
    assert counters["moe.pairs_routed"] * 5 == counters["moe.slots"] * 4     # capacity 1.25
