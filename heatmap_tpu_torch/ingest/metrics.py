"""Ingest-loop metric handles on the shared obs registry.

The port's copy of heatmap_tpu/ingest/metrics.py: the same series.
``run_ingest`` feeds the ``ingest_*`` handles; ``record_stream_tick``
serves ``stream``.

Module-level, created once at import (the delta/metrics.py pattern):
handles survive ``registry.reset()`` between tests and self-gate on
``registry.enabled``, so call sites pay one boolean when metrics are
off. Semantics are documented in docs/observability.md.
"""

from __future__ import annotations

from heatmap_tpu_torch import obs

_registry = obs.get_registry()

INGEST_TICKS = _registry.counter(
    "ingest_ticks_total",
    "Continuous-ingest ticks completed (one micro-batch journaled, "
    "applied, published)",
    labelnames=("status",))  # status = applied | duplicate
INGEST_POINTS = _registry.counter(
    "ingest_points_total",
    "Points consumed by the continuous-ingest loop")
INGEST_WATERMARK = _registry.gauge(
    "ingest_watermark",
    "Event-time watermark: monotonic max of applied batch timestamps "
    "(event-time seconds, NOT wall clock)")
INGEST_QUEUE_DEPTH = _registry.gauge(
    "ingest_queue_depth",
    "Micro-batches waiting in the bounded queue at last dequeue")
INGEST_LAG_SECONDS = _registry.histogram(
    "ingest_lag_seconds",
    "Ingest-to-servable lag: micro-batch enqueue to publish complete",
    buckets=(0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0))
INGEST_TICK_SECONDS = _registry.histogram(
    "ingest_tick_seconds",
    "Wall-clock of one ingest tick (journal + cascade apply + publish)",
    buckets=(0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0))


def record_stream_tick(t: float):
    """Per-tick telemetry of the ``stream`` command's tick loop.

    ``stream_ticks_total`` and ``stream_time_seconds``, as the JAX
    package keeps them; ``streaming.default_stream_hook`` calls it. No-op
    unless a metrics sink is enabled.
    """
    if not obs.metrics_enabled():
        return
    obs.STREAM_TICKS.inc()
    obs.STREAM_TIME.set(float(t))
