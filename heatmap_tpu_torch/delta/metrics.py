"""Delta-engine metric handles on the shared obs registry (the port's
copy of heatmap_tpu/delta/metrics.py).

Module-level, created once at import (the serve/cache.py pattern):
handles survive ``registry.reset()`` between tests and self-gate on
``registry.enabled``, so call sites pay one boolean when metrics are
off.
"""

from __future__ import annotations

from heatmap_tpu_torch import obs

_registry = obs.get_registry()

DELTA_POINTS = _registry.counter(
    "delta_points_total", "Points ingested by incremental delta applies",
    labelnames=("kind",))  # kind = insert | retract
DELTA_APPLY_SECONDS = _registry.histogram(
    "delta_apply_seconds",
    "Wall-clock of one journaled delta apply (hash + cascade + journal)",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))
COMPACTION_SECONDS = _registry.histogram(
    "compaction_seconds",
    "Wall-clock of folding the live delta stack into a new base",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))
QUARANTINE_BYTES = _registry.gauge(
    "quarantine_bytes",
    "Bytes held in the most recently swept store's quarantine/ dir")
