"""Port parity: the models as workflow DAGs and their placement on H100 fleets.

``repro_torch.core.modelgraph.build_model_graph`` against JAX's on every
``ARCH_IDS`` x named ``SHAPES`` pair (the port's configs against JAX's): tasks,
work, memory, edges, labels and ``TaskInfo`` equal.  Then
``repro_torch.core.autoshard.plan`` of every arch, on the port's own
``h100_fleet_si`` fleets, against JAX's ``plan`` on the same processors
(the fleet copied into JAX's ``Platform`` here, in the test only): one
card and two at 2 x 4096 prefill (``chip_smoke.py`` phase 29's shape),
and 56 cards with 8 degraded at ``decode_32k``; stages, processors,
memory, estimates and expert placement equal, floats under ``==``.
"""
import dataclasses

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import Platform as JPlatform
from repro.core import Processor as JProcessor
from repro.core.autoshard import plan as j_plan
from repro.core.modelgraph import build_model_graph as j_build_model_graph
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import h100_fleet_si
from repro_torch.core.autoshard import default_microbatches, plan
from repro_torch.core.modelgraph import build_model_graph
from repro_torch.obs.metrics import METRICS

PREFILL = (2, 4096)
# the named shapes of both packages (other test modules register more in
# ``SHAPES`` when they are imported, so the list is fixed here)
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
FLEETS = {"1": ({"h100": 1}, "prefill", "auto"),
          "2": ({"h100": 2}, "prefill", "auto"),
          "56+8": ({"h100": 56, "h100-degraded": 8}, "decode_32k", [8, 16, 32, 64])}


@pytest.fixture(autouse=True)
def _isolate_port_metrics():
    snap = METRICS.snapshot()
    yield
    METRICS.restore(snap)


def _shapes(name):
    if name == "prefill":
        b, s = PREFILL
        return (ShapeConfig("prefill", seq_len=s, global_batch=b, kind="prefill"),
                JShapeConfig("prefill", seq_len=s, global_batch=b, kind="prefill"))
    return SHAPES[name], J_SHAPES[name]


def _jax_platform(fleet):
    """The port's fleet as JAX's ``Platform``: the same processors and β."""
    return JPlatform([JProcessor(p.name, p.speed, p.memory) for p in fleet.procs],
                     fleet.bandwidth, fleet.name, dict(fleet.link_bandwidth))


def test_the_shapes_are_jax_shapes():
    for name in SHAPE_NAMES:
        assert dataclasses.astuple(SHAPES[name]) == dataclasses.astuple(J_SHAPES[name])


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_graph_equal(arch, shape):
    ours, ref = _shapes(shape)
    mb = default_microbatches(ours)
    wf, info = build_model_graph(get_config(arch), ours, microbatches=mb)
    jwf, jinfo = j_build_model_graph(j_get_config(arch), ref, microbatches=mb)
    assert (wf.n, wf.name, wf.n_edges) == (jwf.n, jwf.name, jwf.n_edges)
    assert list(wf.work) == list(jwf.work)
    assert list(wf.mem) == list(jwf.mem)
    assert list(wf.persistent) == list(jwf.persistent)
    assert [dict(s) for s in wf.succ] == [dict(s) for s in jwf.succ]
    assert list(wf.labels) == list(jwf.labels)
    assert {t: dataclasses.astuple(i) for t, i in info.items()} == {
        t: dataclasses.astuple(i) for t, i in jinfo.items()}


def _plan_record(p):
    if p is None:
        return None
    return dict(n_stages=p.n_stages, stage_of_task=p.stage_of_task,
                proc_of_stage=p.proc_of_stage, stage_members=p.stage_members,
                expert_placement=p.expert_placement, stage_memory=p.stage_memory,
                est_step_s=p.est_step_s, est_bottleneck_s=p.est_bottleneck_s,
                critical_stages=p.critical_stages, valid=p.valid, algo=p.algo)


@pytest.mark.parametrize("fleet", list(FLEETS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_equal_on_h100_fleets(arch, fleet):
    spec, shape, kprime = FLEETS[fleet]
    ours, ref = _shapes(shape)
    platform = h100_fleet_si(spec)
    p = plan(get_config(arch), ours, platform, kprime=kprime)
    jp = j_plan(j_get_config(arch), ref, _jax_platform(platform), kprime=kprime)
    assert _plan_record(p) == _plan_record(jp)
    if p is not None:
        assert p.valid and p.est_step_s == jp.est_step_s
        assert [m == jm for m, jm in zip(p.stage_memory, jp.stage_memory)] == [True] * p.n_stages


def test_plan_of_the_issue_table():
    """The placements ``chip_smoke.py`` phase 29 checks on the card: llama3_8b
    and olmoe_1b_7b in one stage on one H100, mixtral_8x7b on none of one
    card and in two stages on two."""
    ours, _ = _shapes("prefill")
    one, two = h100_fleet_si({"h100": 1}), h100_fleet_si({"h100": 2})
    for arch, gib, est in (("llama3_8b", 15.20703125, 0.1421), ("olmoe_1b_7b", 13.2314453125,
                                                                   0.0240)):
        p = plan(get_config(arch), ours, one)
        assert p.n_stages == 1 and p.valid
        assert p.stage_memory[0] / 2**30 == gib and round(p.est_step_s, 4) == est
    assert plan(get_config("mixtral_8x7b"), ours, one) is None
    p = plan(get_config("mixtral_8x7b"), ours, two)
    assert p.n_stages == 2 and p.valid and p.proc_of_stage == [0, 1]
    assert [round(m / 2**30, 2) for m in p.stage_memory] == [43.81, 43.81]
