"""Process-wide observability of the port: the metrics registry and the
lifecycle journal.

The part of the JAX package's ``obs/__init__.py`` that the port has:
:mod:`obs.registry` (counters, gauges and histograms in one process-wide
:class:`MetricsRegistry`) and :mod:`obs.events` (the JSONL lifecycle
journal behind ``obs_events_file``), both copied from the JAX package
whole, stdlib only. The data loader counts quarantines, worker restarts
and stalls in :func:`process_registry` and journals ``loader_stall``,
``loader_worker_restart`` and ``quarantine`` events. The JAX package's
tracing, cost model, HBM census, SLOs, flight recorder and HTTP
telemetry are not ported; ``serving/metrics.py`` keeps its own subset.
"""

from __future__ import annotations

from . import events
from .registry import (Counter, Gauge, Histogram, MetricsGroup,
                       MetricsRegistry, ServingMetrics, merge_snapshots,
                       metrics_on, process_registry, render_snapshot_text,
                       reset_process_registry, step_registry)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "ServingMetrics",
    "MetricsGroup", "merge_snapshots", "render_snapshot_text",
    "process_registry", "reset_process_registry", "metrics_on",
    "step_registry", "events",
]
