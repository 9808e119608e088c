"""repro_torch.throughput — steady-state pipelined scheduling of repeated
workflow instances.

One mapped plan answers "how fast can *one* instance finish"; this
subsystem answers "how many instances per second can the platform
*sustain*".  Three layers:

* **steady state** (:mod:`~repro_torch.throughput.replicate`) — the
  sustainable period of a mapped plan is its bottleneck processor's
  busy time per instance (compute + transfer occupancy), and idle
  processors can host *replica groups* of the whole mapping (matched
  by speed/memory dominance, so feasibility and the latency bound are
  inherited).  Instances deal round-robin to groups:
  ``rate = n_groups / max_g period_g``.
* **pipelined replay** (:mod:`~repro_torch.throughput.pipeline`) — N
  instances lowered into one :mod:`repro_torch.sim` engine pass, released at
  seeded arrival instants (:mod:`~repro_torch.throughput.arrivals`), with a
  memory-occupancy trace summed across in-flight instances.  One
  instance at rate→0 reproduces ``sim.simulate`` bit-exactly.
* **planning** (:mod:`~repro_torch.throughput.plan`) — the scheduler's
  ``throughput`` pipeline prices every k' attempt's replicated rate;
  :func:`plan_throughput` picks the rate maximizer (k' and replication
  count jointly), :func:`saturation_sweep` maps the latency/throughput
  curve.

Entry points::

    from repro_torch.throughput import plan_throughput, simulate_pipelined
    tr = plan_throughput(wf, platform, latency_bound=2.0)
    tr.rate, tr.plan.n_replicas
    rep = simulate_pipelined(tr.best, platform, rate=0.8 * tr.rate,
                             n_instances=64)
    rep.achieved_rate, rep.percentile_latency(99), rep.memory.feasible

Service-level sustained admission (arrival stream → ``ServiceReport``
with p50/p99 and the saturation point) lives in
:func:`repro_torch.service.run_sustained`.
"""
from __future__ import annotations

from .arrivals import ArrivalSpec
from .pipeline import (
    InstanceRecord,
    PipelinedReport,
    build_pipelined_specs,
    simulate_pipelined,
)
from .plan import ThroughputResult, plan_throughput, saturation_sweep
from .replicate import (
    ReplicaGroup,
    ThroughputPlan,
    proc_busy_times,
    replicate_plan,
)

__all__ = [
    "ArrivalSpec",
    "InstanceRecord",
    "PipelinedReport",
    "ReplicaGroup",
    "ThroughputPlan",
    "ThroughputResult",
    "build_pipelined_specs",
    "plan_throughput",
    "proc_busy_times",
    "replicate_plan",
    "saturation_sweep",
    "simulate_pipelined",
]
