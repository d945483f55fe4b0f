"""Temporal-plane metric handles on the port's obs registry (the
delta/metrics.py pattern: module-level handles, created once, gated on
``registry.enabled``)."""

from __future__ import annotations

from heatmap_tpu_torch import obs

_registry = obs.get_registry()

TEMPORAL_FOLD_SECONDS = _registry.histogram(
    "temporal_fold_seconds",
    "Wall-clock of one partial-pyramid fold (bucket select + merge + "
    "index build)",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0))
TEMPORAL_REQUESTS = _registry.counter(
    "temporal_requests_total",
    "Requests answered through a temporal fold",
    labelnames=("mode",))  # mode = as_of | window | decay | growth
