"""Admission control: per-tenant quotas and weighted fair-share order.

Quotas bound what one tenant can take (queue depth, concurrent jobs,
per-submission size); the :class:`FairQueue` decides *who goes next*
when capacity frees up.  Ordering is classic weighted fair queueing on
accumulated service: each tenant accrues virtual service equal to the
total work it has dispatched divided by its weight, and the queue
always offers the waiting job of the least-served tenant first (ties:
earlier arrival, then submission order — fully deterministic).  A
tenant with weight 2 therefore drains twice the work per unit of
contention as a weight-1 tenant, and an idle tenant's first job jumps
ahead of a heavy tenant's backlog.

Quota checks return structured verdicts through the service
(:class:`~repro_torch.service.submission.Rejection` /
:class:`~repro_torch.service.submission.Deferral`) — admission never raises
on untrusted input.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterable

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .loop import _Job

__all__ = ["FairQueue", "QuotaConfig", "TenantQuota"]


@dataclass(frozen=True)
class TenantQuota:
    """Limits for one tenant (``None`` = unlimited).

    ``weight`` scales the tenant's fair share (2.0 = twice the
    service); ``max_pending`` bounds queued-but-not-dispatched jobs,
    ``max_running`` bounds concurrently executing jobs, ``max_tasks``
    bounds a single submission's task count.
    """

    weight: float = 1.0
    max_pending: int | None = None
    max_running: int | None = None
    max_tasks: int | None = None

    def __post_init__(self) -> None:
        if not self.weight > 0:
            raise ValueError(
                f"tenant weight must be positive, got {self.weight!r}")


@dataclass
class QuotaConfig:
    """Per-tenant quotas with a default for unlisted tenants.

    The empty config (no tenants, default :class:`TenantQuota`) is the
    identity: every submission admitted, FIFO order degenerates to
    arrival order — the service's single-job anchor relies on this.
    """

    tenants: dict[str, TenantQuota] = field(default_factory=dict)
    default: TenantQuota = field(default_factory=TenantQuota)

    def quota(self, tenant: str) -> TenantQuota:
        return self.tenants.get(tenant, self.default)


class FairQueue:
    """Deterministic weighted fair-share queue over admitted jobs."""

    def __init__(self, quotas: QuotaConfig) -> None:
        self._quotas = quotas
        self._jobs: list["_Job"] = []
        self._service: dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._jobs)

    def push(self, job: "_Job") -> None:
        self._jobs.append(job)

    def remove(self, job: "_Job") -> None:
        self._jobs.remove(job)

    def pending(self, tenant: str) -> int:
        return sum(1 for j in self._jobs if j.tenant == tenant)

    def charge(self, tenant: str, amount: float) -> None:
        """Accrue ``amount`` of raw service (dispatched work) to
        ``tenant`` — normalization by weight happens at ordering."""
        self._service[tenant] = self._service.get(tenant, 0.0) + amount

    def normalized_service(self, tenant: str) -> float:
        return (self._service.get(tenant, 0.0)
                / self._quotas.quota(tenant).weight)

    def fair_order(self) -> Iterable["_Job"]:
        """Waiting jobs, least-served tenant first (see module doc).

        A snapshot: callers may dispatch (and :meth:`remove`) while
        iterating.  Service accrued mid-iteration does not reorder the
        current round — one round, one consistent ordering.
        """
        return sorted(
            self._jobs,
            key=lambda j: (self.normalized_service(j.tenant),
                           j.arrival_t, j.seq),
        )
