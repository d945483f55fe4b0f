"""Write-plane metric handles on the shared obs registry.

Module-level, created once at import (the delta/metrics.py pattern):
handles survive ``registry.reset()`` between tests and self-gate on
``registry.enabled``, so call sites pay one boolean when metrics are
off.
"""

from __future__ import annotations

from heatmap_tpu_torch import obs

_registry = obs.get_registry()

WRITEPLANE_POINTS = _registry.counter(
    "writeplane_points_total",
    "Points applied through the partitioned write plane, per range",
    labelnames=("range",))
WRITEPLANE_APPENDS = _registry.counter(
    "writeplane_appends_total",
    "Per-range sub-batch applies (status = applied|duplicate|error)",
    labelnames=("range", "status"))
WRITEPLANE_APPEND_SECONDS = _registry.histogram(
    "writeplane_append_seconds",
    "Wall-clock of one routed full-batch append across its ranges",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))
WRITEPLANE_PUBLISHES = _registry.counter(
    "writeplane_publishes_total",
    "Manifest epochs published (the cross-range visibility flips)")
WRITEPLANE_MANIFEST_EPOCH = _registry.gauge(
    "writeplane_manifest_epoch",
    "Newest manifest epoch published by this process's write plane")
WRITEPLANE_REBALANCES = _registry.counter(
    "writeplane_rebalances_total",
    "Hot-range re-splits performed (journal handoff + new range)")
