"""What enters the service: submissions, and their structured fates.

A :class:`Submission` is one unit of demand: a workflow (live
:class:`~repro_torch.core.dag.Workflow`, JSON text, or a parsed JSON dict —
the latter two model untrusted wire input), the tenant it belongs to,
its virtual arrival time, and an optional deadline.  Submission
*metadata* is validated eagerly (the caller building the trace is
trusted code, so a bad ``arrival_t`` raises); the workflow *payload* is
validated lazily at admission via :func:`resolve_workflow`, so a
malformed body becomes a structured :class:`Rejection` — never an
exception out of the event loop, in the spirit of
:class:`~repro_torch.core.scheduler.Infeasibility`.

:class:`Rejection` is terminal (the job never entered the queue);
:class:`Deferral` is transient (the job stays queued and is retried
whenever capacity changes) and appears in the service log, not as a
job outcome.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass

from repro_torch.core.dag import Workflow
from repro_torch.core.workflows import WorkflowValidationError, from_json

__all__ = ["Deferral", "Rejection", "Submission", "resolve_workflow"]


@dataclass
class Submission:
    """One workflow arriving at ``arrival_t`` on behalf of ``tenant``."""

    workflow: Workflow | str | dict
    tenant: str = "default"
    arrival_t: float = 0.0
    deadline: float | None = None
    name: str = ""

    def __post_init__(self) -> None:
        if not (math.isfinite(self.arrival_t) and self.arrival_t >= 0):
            raise ValueError(
                f"arrival_t must be finite and >= 0, "
                f"got {self.arrival_t!r}")
        if self.deadline is not None and not (
                math.isfinite(self.deadline)
                and self.deadline >= self.arrival_t):
            raise ValueError(
                f"deadline must be finite and >= arrival_t, "
                f"got {self.deadline!r}")
        if not self.name:
            if isinstance(self.workflow, Workflow):
                self.name = self.workflow.name
            else:
                self.name = "submission"


def resolve_workflow(sub: Submission) -> Workflow:
    """Materialize the submission's workflow, validating untrusted
    payloads (raises :class:`WorkflowValidationError` — the admission
    path turns that into a :class:`Rejection`)."""
    payload = sub.workflow
    if isinstance(payload, Workflow):
        return payload
    if isinstance(payload, dict):
        payload = json.dumps(payload)
    if isinstance(payload, str):
        return from_json(payload)
    raise WorkflowValidationError(
        "bad-schema",
        f"workflow payload must be a Workflow, JSON text or dict, "
        f"got {type(payload).__name__}")


@dataclass
class Rejection:
    """Terminal: the submission never entered the admission queue.

    ``code`` is stable and machine-readable: ``"malformed"`` (payload
    failed validation), ``"size-quota"`` (more tasks than the tenant's
    ``max_tasks``), ``"queue-quota"`` (tenant's ``max_pending``
    exceeded).
    """

    time: float
    job_id: int
    name: str
    tenant: str
    code: str
    reason: str

    def to_dict(self) -> dict:
        return {
            "time": self.time, "job_id": self.job_id,
            "name": self.name, "tenant": self.tenant,
            "code": self.code, "reason": self.reason,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Rejection":
        return cls(time=float(d["time"]), job_id=int(d["job_id"]),
                   name=str(d["name"]), tenant=str(d["tenant"]),
                   code=str(d["code"]), reason=str(d["reason"]))


@dataclass
class Deferral:
    """Transient: an admitted job could not be dispatched right now.

    ``code``: ``"capacity"`` (no feasible plan on the currently free
    processors — retried when capacity changes) or ``"running-quota"``
    (tenant already at ``max_running``).  Deferrals are log entries,
    never job outcomes.
    """

    time: float
    job_id: int
    name: str
    tenant: str
    code: str
    reason: str

    def to_dict(self) -> dict:
        return {
            "time": self.time, "job_id": self.job_id,
            "name": self.name, "tenant": self.tenant,
            "code": self.code, "reason": self.reason,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Deferral":
        return cls(time=float(d["time"]), job_id=int(d["job_id"]),
                   name=str(d["name"]), tenant=str(d["tenant"]),
                   code=str(d["code"]), reason=str(d["reason"]))
