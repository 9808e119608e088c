"""repro_torch.service — scheduler-as-a-service: continuous multi-workflow
operation with a fingerprinted plan cache.

The paper's mapper plans one workflow, once.  This subsystem runs the
mapper as a long-lived *service*: workflows arrive over virtual time on
behalf of tenants, pass admission control (per-tenant quotas, weighted
fair-share ordering), get planned onto a carved slice of the shared
platform — through a plan cache keyed on a structural workflow
fingerprint, so repeat pipelines skip the k' sweep entirely
(:meth:`Scheduler.seeded <repro_torch.core.scheduler.Scheduler.seeded>`) —
execute in the discrete-event simulator, and survive mid-run platform
events by warm-start replanning (:func:`repro_torch.scenario.freeze_prefix`).
Everything is deterministic in virtual time: the same submission trace
and event timeline yield a bit-identical :class:`ServiceTrace`,
whatever the wall clock or worker count did.

::

    from repro_torch.core import default_cluster, generate_workflow
    from repro_torch.service import Submission, run_service

    plat = default_cluster()
    subs = [Submission(generate_workflow("montage", 80, seed=s,
                                         platform=plat),
                       tenant="alice", arrival_t=10.0 * s)
            for s in range(4)]
    report = run_service(subs, plat)
    report.completed            # JobRecords with latency/queue-wait
    report.cache_hit_rate       # plan-cache effectiveness
    print(report.gantt())       # stitched multi-job timeline

Structured outcomes, never exceptions: a malformed payload or quota
violation becomes a :class:`Rejection`; transient pressure becomes a
logged :class:`Deferral`; a job that cannot be planned even with the
whole platform free carries the scheduler's structured
:class:`~repro_torch.core.scheduler.Infeasibility`.  The identity anchor:
one submission at t=0 with no events and empty quotas reproduces
``Scheduler(cfg).schedule(wf, platform)`` with ``simulate=True``
bit-exactly.

Sustained admission of *repeat* arrivals of one workflow — plan once
through the cache, replicate onto idle processors, replay the whole
stream in one pipelined simulation — is :func:`run_sustained` (built
on :mod:`repro_torch.throughput`); the report carries instances/s, the
per-instance latency histogram and the saturation rate.
"""
from __future__ import annotations

from .admission import FairQueue, QuotaConfig, TenantQuota
from .fingerprint import (
    WorkflowFingerprint,
    fingerprint_workflow,
    platform_signature,
)
from .loop import ServiceConfig, WorkflowService, run_service
from .plancache import CachedPlan, PlanCache
from .report import JobRecord, ServiceReport, ServiceTrace
from .submission import Deferral, Rejection, Submission, resolve_workflow
from .sustained import run_sustained

__all__ = [
    "CachedPlan",
    "Deferral",
    "FairQueue",
    "JobRecord",
    "PlanCache",
    "QuotaConfig",
    "Rejection",
    "ServiceConfig",
    "ServiceReport",
    "ServiceTrace",
    "Submission",
    "TenantQuota",
    "WorkflowFingerprint",
    "WorkflowService",
    "fingerprint_workflow",
    "platform_signature",
    "resolve_workflow",
    "run_service",
    "run_sustained",
]
