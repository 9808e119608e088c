"""The port's device spans and MoE counters (``repro_torch.obs``).

With no profiler recording, ``device_span`` is the shared no-op and no
``record_function`` is entered, and ``moe_ffn`` counts nothing (no
counting kernel is dispatched).  Under a CPU ``torch.profiler``, a smoke
olmoe-style LM's prefill shows every layer span nested as documented
under the caller's range, a train step shows its three phases, the
results are bit-equal with the spans and counters on and off, and the
counters' deltas equal the routing's own counts.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.convert import flatten_tree
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models.moe import init_moe, moe_capacity, moe_ffn, moe_route
from repro_torch.models.layers import Initializer
from repro_torch.obs import METRICS, device_span, profiler_recording
from repro_torch.obs.tracer import _NULL_SPAN
from repro_torch.runtime.train_loop import Trainer, TrainerConfig

CFG = get_smoke_config("olmoe_1b_7b")
TINY = ShapeConfig("tiny_train", seq_len=16, global_batch=4, kind="train")
ATTENTION = ("repro_torch.attention", "repro_torch.attention.core")
MOE = ("repro_torch.moe", "repro_torch.moe.route", "repro_torch.moe.dispatch",
       "repro_torch.moe.experts", "repro_torch.moe.combine")
# each span and the span (or the caller's range) directly around it
PARENT = {"repro_torch.attention": "caller", "repro_torch.attention.core": "repro_torch.attention",
          "repro_torch.moe": "caller", "repro_torch.moe.route": "repro_torch.moe",
          "repro_torch.moe.dispatch": "repro_torch.moe", "repro_torch.moe.experts": "repro_torch.moe",
          "repro_torch.moe.combine": "repro_torch.moe"}
TRAIN = ("repro_torch.train.forward", "repro_torch.train.backward", "repro_torch.train.adamw")


@pytest.fixture(autouse=True)
def _isolate_port_metrics():
    snap = METRICS.snapshot()
    yield
    METRICS.restore(snap)


def _lm():
    return LM(CFG, seed=3, device="cpu", param_dtype=torch.float32)


def _tokens(seed=0):
    return torch.randint(0, CFG.vocab_size, (2, 16), generator=torch.Generator().manual_seed(seed))


def _trainer(tmp_path, name):
    return Trainer(CFG, TINY, TrainerConfig(steps=3, ckpt_dir=str(tmp_path / name)),
                   attn_chunk=8, device="cpu")


def _step(trainer):
    params, state, _ = trainer.init_or_restore()
    params, state, met = trainer.step_fn(params, state, trainer.batch(trainer.data.batch_at(0)))
    return params, met


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof, tmp_path) -> list:
    """The trace's user ranges as (start, end, name, tid), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["tid"])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda r: (r[0], -r[1]))


def _parent(r, ranges):
    """The innermost other range of ``r``'s thread that encloses it."""
    around = [o for o in ranges if o is not r and o[3] == r[3] and o[0] <= r[0] and r[1] <= o[1]]
    return max(around, key=lambda o: o[0])[2] if around else None


class _Ops(TorchDispatchMode):
    """The aten overloads dispatched in the ``with`` body."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_without_a_profiler_the_span_is_the_shared_null_object():
    assert not profiler_recording()
    assert device_span("repro_torch.moe") is _NULL_SPAN
    with _cpu_profile():
        assert profiler_recording()
        assert device_span("repro_torch.moe") is not _NULL_SPAN
    assert device_span("repro_torch.moe") is _NULL_SPAN


def test_without_a_profiler_no_range_is_entered_and_nothing_counted(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = METRICS.snapshot()
    assert torch.isfinite(serve.prefill(_lm(), _tokens())).all()
    _, met = _step(_trainer(tmp_path, "t"))
    assert torch.isfinite(met["loss"])
    assert not METRICS._on_device
    assert not any(k.startswith("moe.") for k in METRICS.delta(before).get("counters", {}))


def test_the_counter_dispatches_its_kernel_only_under_a_profiler():
    p = init_moe(Initializer(0, torch.float32, device="cpu"), 16, 24, 4)
    x = torch.randn(2, 8, 16)
    with _Ops() as off:
        moe_ffn(p, x, top_k=2)
    with _cpu_profile(), _Ops() as on:
        moe_ffn(p, x, top_k=2)
    aten_off, aten_on = ([o for o in ops if o.startswith("aten.")] for ops in (off.ops, on.ops))
    assert aten_off == off.ops            # no profiler op: no range entered
    # one aten op more: the slots taken, the call's only whole-tensor sum
    assert "aten.sum.default" not in aten_off
    assert aten_on.count("aten.sum.default") == 1 and len(aten_on) == len(aten_off) + 1


def test_prefill_spans_nest_under_the_callers_range(tmp_path):
    lm, tokens = _lm(), _tokens()
    with _cpu_profile() as prof:
        with record_function("caller"):
            serve.prefill(lm, tokens)
    ranges = _ranges(prof, tmp_path)
    for name in ATTENTION + MOE:
        mine = [r for r in ranges if r[2] == name]
        assert len(mine) == CFG.n_layers, name
        assert all(_parent(r, ranges) == PARENT[name] for r in mine), name
    # within a layer the MoE parts run in order
    moe = [r for r in ranges if r[2] in MOE[1:]]
    assert [r[2] for r in moe] == list(MOE[1:]) * CFG.n_layers


def test_a_train_step_shows_its_three_phases(tmp_path):
    trainer = _trainer(tmp_path, "t")
    params, state, _ = trainer.init_or_restore()
    batch = trainer.batch(trainer.data.batch_at(0))
    with _cpu_profile() as prof:
        with record_function("caller"):
            trainer.step_fn(params, state, batch)
    ranges = _ranges(prof, tmp_path)
    phases = [r for r in ranges if r[2] in TRAIN]
    assert [r[2] for r in phases] == list(TRAIN)
    assert all(_parent(r, ranges) == "caller" for r in phases)
    forward = phases[0]
    inner = {_parent(r, ranges) for r in ranges if r[2] in ("repro_torch.attention",
                                                            "repro_torch.moe")}
    assert inner == {"repro_torch.train.forward"}
    assert sum(forward[0] <= r[0] < forward[1] for r in ranges
               if r[2] == "repro_torch.moe") == CFG.n_layers


def test_results_are_bit_equal_with_spans_and_counters_on_and_off(tmp_path):
    lm, tokens = _lm(), _tokens(1)
    off = serve.prefill(lm, tokens)
    with _cpu_profile():
        on = serve.prefill(lm, tokens)
    assert torch.equal(off, on)
    p_off, m_off = _step(_trainer(tmp_path, "off"))
    with _cpu_profile():
        p_on, m_on = _step(_trainer(tmp_path, "on"))
    assert torch.equal(m_off["loss"], m_on["loss"])
    off, on = flatten_tree(p_off), flatten_tree(p_on)
    assert off.keys() == on.keys()
    assert all(torch.equal(off[k], on[k]) for k in off)


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25, 16.0])
def test_counter_deltas_are_the_routings_counts(capacity_factor):
    g, t, d, e, k = 3, 12, 16, 4, 2
    p = init_moe(Initializer(5, torch.float32, device="cpu"), d, 24, e)
    x = torch.randn(g, t, d, generator=torch.Generator().manual_seed(7))
    route = moe_route(p, x, top_k=k, capacity_factor=capacity_factor)
    before = METRICS.snapshot()
    with _cpu_profile():
        moe_ffn(p, x, top_k=k, capacity_factor=capacity_factor)
    moved = METRICS.delta(before)["counters"]
    cap = moe_capacity(t, e, k, capacity_factor)
    assert moved["moe.pairs_routed"] == g * t * k
    assert moved["moe.slots"] == g * e * cap
    assert moved["moe.slots_taken"] == int((route.sel_vals > 0).sum())
    dropped = moved["moe.pairs_routed"] - moved["moe.slots_taken"]
    assert dropped == route.dropped()
    if capacity_factor == 0.25:
        assert dropped > 0
    if capacity_factor == 16.0:
        assert dropped == 0


def test_device_counts_fold_when_the_registry_is_read():
    METRICS.device_counter("moe.slots_taken", torch.tensor(5))
    METRICS.device_counter("moe.slots_taken", torch.tensor(7))
    assert METRICS._on_device and "moe.slots_taken" not in METRICS.counters
    assert METRICS.snapshot()["counters"]["moe.slots_taken"] == 12
    assert not METRICS._on_device
    METRICS.device_counter("moe.slots_taken", torch.tensor(1))
    METRICS.reset()
    assert not METRICS._on_device and not METRICS.counters
