"""``repro_torch.obs`` — spans, typed metrics, Chrome-trace/JSONL export.

The observability layer the scheduler (:mod:`repro_torch.core.scheduler`),
simulator (:mod:`repro_torch.sim`), scenario runner and service loop
(:mod:`repro_torch.service`) are instrumented with:

* :mod:`repro_torch.obs.tracer` — hierarchical wall-clock spans
  (``run → sweep_point → stage.* → probe.*`` on the scheduler side,
  ``service.admit / service.dispatch / service.plan / service.replan /
  service.complete`` on the service side) behind a no-op fast path,
  and the model code's device spans (``repro_torch.attention``,
  ``repro_torch.moe.*``, ``repro_torch.train.*``), which are
  ``torch.profiler`` ranges while a profiler records and no-ops
  otherwise;
* :mod:`repro_torch.obs.metrics` — the :data:`~repro_torch.obs.metrics.METRICS`
  registry of counters + gauges + fixed-bucket histograms
  (``repro_torch.core.counters`` is its counter facet), with the
  snapshot/delta/merge protocol that ships per-worker metrics back
  through ``SweepPoint`` picklably;
* :mod:`repro_torch.obs.export` — Chrome trace-event JSON
  (``chrome://tracing`` / Perfetto) with wall and virtual clock
  domains on separate ``pid``\\ s, and the :class:`JsonlSink` event
  log.

Everything is driven by an :class:`ObsConfig` threaded through
``SchedulerConfig(obs=...)`` and ``ServiceConfig(obs=...)``.  The
contract: instrumentation is **inert** (bit-identical makespans and
service traces on/off) and near-free when disabled.  See
``docs/observability.md`` for the span taxonomy and metric names, and
``docs/observability_torch.md`` for the device spans and MoE counters.
"""
from __future__ import annotations

import logging
import sys
from dataclasses import dataclass

from .export import (
    JsonlSink,
    service_virtual_events,
    sim_proc_events,
    span_events,
    write_chrome_trace,
)
from .metrics import (
    DEFAULT_BOUNDARIES,
    METRICS,
    Histogram,
    MetricsRegistry,
    RATIO_BOUNDARIES,
    percentile,
    percentiles,
)
from .tracer import (
    Span,
    Tracer,
    activate,
    current_tracer,
    device_span,
    profiler_recording,
    span_attr,
    trace_span,
    tracing_active,
)

__all__ = [
    "DEFAULT_BOUNDARIES",
    "Histogram",
    "JsonlSink",
    "METRICS",
    "MetricsRegistry",
    "ObsConfig",
    "RATIO_BOUNDARIES",
    "Span",
    "Tracer",
    "activate",
    "current_tracer",
    "device_span",
    "percentile",
    "percentiles",
    "profiler_recording",
    "service_virtual_events",
    "setup_logging",
    "sim_proc_events",
    "span_attr",
    "span_events",
    "trace_span",
    "tracing_active",
    "write_chrome_trace",
]


@dataclass(frozen=True)
class ObsConfig:
    """One switchboard for a run's observability (picklable).

    ``enabled`` turns span tracing on (metrics/counters always record:
    they are cheap, and reports carry their deltas regardless).
    ``sink`` names a JSONL event-log path — service narration and span
    records stream there as they happen.  ``trace_path`` writes the
    Chrome trace at the end of the run.  ``probe_spans`` opts into
    per-probe spans in the incremental engine (off by default; see
    :class:`~repro_torch.obs.tracer.Tracer`).
    """

    enabled: bool = False
    sink: str | None = None
    trace_path: str | None = None
    probe_spans: bool = False

    def make_tracer(self) -> Tracer | None:
        """A fresh tracer when ``enabled``, else ``None`` (feed to
        :func:`activate`, which treats ``None`` as a passthrough)."""
        if not self.enabled:
            return None
        return Tracer(probe_spans=self.probe_spans)


def setup_logging(level: int = logging.INFO, *,
                  stream=None) -> logging.Logger:
    """Attach a plain-message handler to the ``repro_torch`` logger.

    The library logs through module-level ``logging`` loggers and, per
    library convention, never installs handlers on import — narration
    is silent until the application configures logging.  CLI entry
    points (``repro_torch.launch.*``, benchmarks) call this to restore the
    classic ``print()`` behaviour: bare messages, no timestamps, to
    ``stdout``.  Idempotent.
    """
    logger = logging.getLogger("repro_torch")
    if not any(getattr(h, "_repro_default", False)
               for h in logger.handlers):
        h = logging.StreamHandler(stream if stream is not None
                                  else sys.stdout)
        h.setFormatter(logging.Formatter("%(message)s"))
        h._repro_default = True
        logger.addHandler(h)
    logger.setLevel(level)
    return logger
