"""The metric readers on synthetic records: tokens/s and p95 over a
closed-loop timeline that holds a stall, the traced sub-window's
reduction, the rooflines and the readers that find nothing to read."""
import statistics

import pytest

from chipbench import flops, harness, trace

OLMOE = {"n_layers": 16, "d_model": 2048, "n_heads": 16, "n_kv_heads": 16, "head_dim": 0,
         "d_ff": 1024, "vocab_size": 50304, "n_experts": 64, "experts_per_token": 8,
         "sliding_window": 0}


def _closed_loop(call_s, clients, seq):
    """The record of a closed loop whose calls took ``call_s`` seconds each,
    back to back: every client's request waits for its batch's call."""
    t, lat = 0.0, []
    for c in call_s:
        lat.extend([c * 1e3] * clients)
        t += c
    return {"kind": "prefill", "model": OLMOE, "seq_len": seq, "batch": clients,
            "tokens": len(call_s) * clients * seq, "window_s": t, "latencies_ms": lat}


def test_tokens_per_s_counts_all_work_over_all_time():
    steady = _closed_loop([0.25] * 100, 4, 4096)
    stalled = _closed_loop([0.25] * 99 + [2.25], 4, 4096)
    assert harness.read_metric("prefill_tokens_per_s", steady) == pytest.approx(4 * 4096 / 0.25)
    # one call stalled 2 s: the same work over 2 s more
    assert harness.read_metric("prefill_tokens_per_s", stalled) == pytest.approx(
        100 * 4 * 4096 / (99 * 0.25 + 2.25))


def test_p95_is_the_tail_of_every_request():
    calls = [0.25] * 90 + [0.5] * 10          # 40 of 400 requests at 500 ms
    rec = _closed_loop(calls, 4, 4096)
    p95 = harness.read_metric("prefill_p95_ms", rec)
    assert p95 == pytest.approx(statistics.quantiles(rec["latencies_ms"], n=100,
                                                     method="inclusive")[94])
    assert p95 == pytest.approx(500.0)
    assert harness.read_metric("prefill_p95_ms", _closed_loop([0.25] * 100, 4, 4096)) == 250.0


def test_train_tokens_and_mfu():
    rec = {"kind": "train", "model": {**OLMOE, "n_layers": 8}, "seq_len": 4096, "batch": 1,
           "tokens": 40 * 4096, "window_s": 20.0}
    assert harness.read_metric("train_tokens_per_s", rec) == pytest.approx(40 * 4096 / 20)
    per_token = flops.model_flops_per_token(rec["model"], 4096, "train")
    assert harness.read_metric("mfu.train", rec) == pytest.approx(
        100 * per_token * 40 * 4096 / 20 / 989e12)
    assert harness.read_metric("prefill_tokens_per_s", rec) is None
    assert harness.read_metric("mfu.prefill", rec) is None


def _chrome(events):
    return {"traceEvents": [{"ph": "X", "cat": c, "name": n, "ts": a, "dur": b - a, "tid": t}
                            for c, n, a, b, t in events]}


SYNTH = [
    ("user_annotation", "chipbench.window", 0.0, 1000.0, 1),
    ("user_annotation", "chipbench.prefill", 0.0, 700.0, 1),
    ("cpu_op", "aten::nonzero", 300.0, 420.0, 1),
    ("user_annotation", "chipbench.to_host", 700.0, 1000.0, 1),
    ("kernel", "flash_fwd_wgmma_kernel<128>", 10.0, 300.0, 7),
    ("kernel", "nvjet_tst_128x256_gemm", 250.0, 350.0, 8),      # overlaps the first
    ("kernel", "nvjet_tst_128x256_gemm", 450.0, 650.0, 7),
    ("gpu_memcpy", "Memcpy DtoH", 700.0, 750.0, 7),
    ("gpu_user_annotation", "chipbench.prefill", 0.0, 700.0, 7),
    ("kernel", "outside", 1200.0, 1300.0, 7),
]


def test_summarize_unions_device_time_and_names_gaps():
    s = trace.summarize(trace.read_events(_chrome(SYNTH)))
    assert s["window_s"] == pytest.approx(1e-3)
    # busy: [10, 350] + [450, 650] + [700, 750] = 590 us
    assert s["busy_s"] == pytest.approx(590e-6)
    assert s["kernels"]["nvjet_tst_128x256_gemm"]["launches"] == 2
    assert s["kernels"]["nvjet_tst_128x256_gemm"]["seconds"] == pytest.approx(300e-6)
    assert "outside" not in s["kernels"]
    gaps = dict(s["idle_gaps"])
    assert gaps["chipbench.prefill > aten::nonzero"] == pytest.approx(100e-6)
    assert gaps["chipbench.to_host"] == pytest.approx(250e-6)
    assert s["device_ops"][0][0] == "nvjet_tst_128x256_gemm"


def test_summarize_needs_its_window():
    with pytest.raises(ValueError):
        trace.summarize(trace.read_events(_chrome(SYNTH[1:])))


def test_merge():
    assert trace.merge([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def _traced(kind, launches, kernels):
    return {"kind": kind, "model": OLMOE, "seq_len": 4096, "batch": 4,
            "trace": {"window_s": 2.0, "busy_s": 1.9, "calls": 4, "launches": launches,
                      "kernels": kernels, "adamw_ms": [200.0, 210.0]}}


def test_flash_roofline_from_launched_shapes():
    kernels = {"void flash_fwd_wgmma_kernel<128, true>(...)": {"seconds": 0.02, "launches": 64},
               "nvjet_tst_gemm": {"seconds": 0.3, "launches": 900}}
    rec = _traced("prefill", {"wgmma/causal": 64, "backward_wgmma/causal": 0}, kernels)
    one = flops.bound_s(flops.attention_flops(64, 4096, 128, True),
                        flops.attention_bytes(64, 64, 4096, 128, 2))
    assert harness.read_metric("flash_fwd_roofline.prefill", rec) == pytest.approx(
        100 * 64 * one / 0.02)
    assert harness.read_metric("gemm_ms_per_call.prefill", rec) == pytest.approx(300 / 4)
    assert harness.read_metric("device_idle_share.prefill", rec) == pytest.approx(5.0)
    # no backward launched: nothing to read
    assert harness.read_metric("flash_bwd_roofline.train", rec) is None


def test_train_readers():
    kernels = {"flash_bwd_dq_wgmma_kernel": {"seconds": 0.004, "launches": 8},
               "flash_bwd_dkdv_wgmma_kernel": {"seconds": 0.006, "launches": 8}}
    rec = _traced("train", {"wgmma/causal": 8, "backward_wgmma/causal": 8}, kernels)
    rec["batch"] = 1
    one = flops.bound_s(flops.bwd_flops(16, 4096, 128, True),
                        flops.bwd_bytes(16, 16, 4096, 128, 2))
    assert harness.read_metric("flash_bwd_roofline.train", rec) == pytest.approx(
        100 * 8 * one / 0.010)
    assert harness.read_metric("adamw_ms_per_step.train", rec) == pytest.approx(205.0)
    assert harness.read_metric("device_idle_share.train", rec) == pytest.approx(5.0)
    assert harness.read_metric("device_idle_share.prefill", rec) is None


@pytest.mark.parametrize("name", ["flash_fwd_roofline.prefill", "gemm_ms_per_call.prefill",
                                  "device_idle_share.prefill", "flash_bwd_roofline.train",
                                  "adamw_ms_per_step.train", "prefill_p95_ms"])
def test_nothing_to_read_gives_none(name):
    assert harness.read_metric(name, {"kind": "prefill", "model": OLMOE}) is None


def test_judge_holds_every_number_to_its_limit():
    ok, checks = harness.judge({"a": 0.1, "b": 0.2}, {"numbers": {"a": 0.5, "b": 0.3}})
    assert ok and checks["b"] == {"value": 0.2, "limit": 0.3}
    assert not harness.judge({"a": 0.6}, {"numbers": {"a": 0.5}})[0]
    assert not harness.judge({"a": float("nan")}, {"numbers": {"a": 0.5}})[0]
    assert not harness.judge({}, {"numbers": {"a": 0.5}})[0]


class _FakeTracer:
    """A profiler stand-in for the CPU: the synthetic trace above."""

    @staticmethod
    def warm():
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def read(self):
        return trace.read_events(_chrome(SYNTH))


class _FakeMarks:
    def __call__(self, name):
        pass

    def adamw_ms(self):
        return [250.0]


@pytest.mark.parametrize("workload", ["olmoe_1b_7b.prefill_4x4k", "olmoe_1b_7b.train_1x4k"])
def test_a_traced_run_reports_its_per_layer_metrics(monkeypatch, workload):
    from chipbench.drivers import prefill_closed, train_steps
    monkeypatch.setattr(trace, "Tracer", _FakeTracer)
    monkeypatch.setattr(prefill_closed, "Tracer", _FakeTracer)
    monkeypatch.setattr(train_steps, "Tracer", _FakeTracer)
    monkeypatch.setattr(train_steps, "_Marks", _FakeMarks)
    smoke = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96,
             "vocab_size": 256, "n_experts": 8, "experts_per_token": 2}
    ctx = harness.make_ctx(workload, 5, 0.6, True, device="cpu", config_overrides=smoke,
                           traffic_overrides={"prompt_len": 32, "seq_len": 32})
    out = harness.run_cell(ctx)
    assert out["device"]["busy_s"] == pytest.approx(590e-6)
    assert len(out["breakdown"]["device_ops"]) <= 10
    names = set(out["metrics"])
    if workload.endswith("train_1x4k"):
        assert {"mfu.train", "device_idle_share.train", "adamw_ms_per_step.train"} <= names
    else:
        assert {"mfu.prefill", "device_idle_share.prefill", "gemm_ms_per_call.prefill"} <= names
    assert all(m["value"] > 0 for m in out["metrics"].values())
