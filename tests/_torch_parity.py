"""Helpers shared by the port's parity tests of the scheduler stack.

Nothing here hands an object of one package to the other: platforms and
events cross by value (processors, links, failure rates and power;
``to_dict`` / ``event_from_dict``), and reports are compared through the
JSON both write, with the wall-clock fields set aside.
"""
import json
import textwrap

import pytest

import repro.core as J
import repro.scenario as J_scenario
import repro_torch.core as T
import repro_torch.scenario as T_scenario
from repro.obs.metrics import METRICS as J_METRICS
from repro_torch.obs.metrics import METRICS

_CORE = {"jax": J, "port": T}
_SCENARIO = {"jax": J_scenario, "port": T_scenario}

#: A ``sitecustomize`` that blocks the top-level packages named in
#: ``REPRO_TEST_BLOCKED`` (default ``jax,jaxlib``) in the process that loads
#: it and in every process that one starts with the same path: put its
#: directory first on ``PYTHONPATH``.
JAX_BLOCKER = textwrap.dedent("""
    import importlib
    import os
    import sys

    _BLOCKED = tuple(os.environ.get("REPRO_TEST_BLOCKED", "jax,jaxlib").split(","))

    class _BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in _BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, _BlockJax())
    # hand over to any other sitecustomize further down the path
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _here]
    del sys.modules[__name__]
    try:
        importlib.import_module("sitecustomize")
    except ImportError:
        pass
""")


@pytest.fixture(autouse=True)
def fresh_metrics():
    """Both metrics registries empty at the start of a test, the port's
    restored after it (the JAX package's conftest restores its own).  A
    report's metrics block lists metrics in the order the process first
    registered them, so a byte comparison needs both registries to start
    from the same state."""
    snap = METRICS.snapshot()
    METRICS.reset()
    J_METRICS.reset()
    yield
    METRICS.restore(snap)


def platform_as(plat, side: str):
    """``plat`` (of either package) rebuilt as ``side``'s ``Platform``
    (``"jax"`` or ``"port"``): the same processors, β, name, link
    overrides, failure rates and power models."""
    core = _CORE[side]
    return core.Platform(
        [core.Processor(p.name, p.speed, p.memory) for p in plat.procs],
        plat.bandwidth, plat.name, dict(plat.link_bandwidth),
        dict(plat.failure_rates),
        {j: core.ProcPower(pw.static, pw.dynamic, pw.alpha) for j, pw in plat.power.items()})


def events_as(events, side: str):
    """An event list rebuilt as ``side``'s events through ``to_dict``."""
    return [_SCENARIO[side].event_from_dict(e.to_dict()) for e in events]


def _untime(d: dict) -> dict:
    d["total_time_s"] = 0.0
    d["stage_times"] = {k: 0.0 for k in d["stage_times"]}
    for p in d["sweep"]:
        p["time_s"] = 0.0
        p["stage_times"] = {k: 0.0 for k in p["stage_times"]}
        p["metrics"].get("histograms", {}).pop("sched_sweep_point_s", None)
    d["metrics"].get("histograms", {}).pop("sched_sweep_point_s", None)
    if d["summary"] is not None:
        d["summary"]["runtime_s"] = 0.0
    return d


def untimed_schedule_json(rep) -> str:
    """``ScheduleReport.to_json()`` with its timing fields set to 0 and the
    plan-latency histogram left out (``rep`` itself is not changed)."""
    return json.dumps(_untime(json.loads(rep.to_json())))


def untimed_timeline_json(tl) -> str:
    """``TimelineReport.to_json()`` with the wall-clock fields set aside:
    ``total_time_s``, ``replan_times_s`` and each segment's scheduler
    timing."""
    d = json.loads(tl.to_json())
    d["total_time_s"] = 0.0
    d["replan_times_s"] = [0.0] * len(d["replan_times_s"])
    for seg in d["segments"]:
        _untime(seg["report"])
    return json.dumps(d)


#: histograms whose observations are wall-clock seconds
_WALL_HISTOGRAMS = ("service_plan_latency_s", "sched_sweep_point_s")


def untimed_service_json(rep) -> str:
    """``ServiceReport.to_json()`` with the wall-clock fields set aside:
    ``total_time_s``, each planning call's seconds in ``plan_wall_s`` (the
    paths and the number of calls stay) and the wall-clock histograms, of
    which only the count of observations stays.  The trace inside is kept
    whole: its mappings already carry ``runtime_s`` = 0."""
    d = json.loads(rep.to_json())
    d["total_time_s"] = 0.0
    d["plan_wall_s"] = {k: [0.0] * len(v) for k, v in d["plan_wall_s"].items()}
    hists = d["metrics"].get("histograms", {})
    for name in _WALL_HISTOGRAMS:
        if name in hists:
            hists[name] = {"count": hists[name]["count"]}
    return json.dumps(d)
