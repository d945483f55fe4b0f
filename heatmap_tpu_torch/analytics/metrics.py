"""Analytics metric handles on the shared obs registry (the port's copy
of heatmap_tpu/analytics/metrics.py).

Module-level, created once at import (the delta/metrics.py pattern):
handles survive ``registry.reset()`` between tests and self-gate on
``registry.enabled``. Semantics are documented in
docs/observability.md.
"""

from __future__ import annotations

from heatmap_tpu_torch import obs

_registry = obs.get_registry()

QUERY_SECONDS = _registry.histogram(
    "query_seconds",
    "Wall-clock of answering one /query request, per operation",
    labelnames=("op",),
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0))
INTEGRAL_BYTES = _registry.gauge(
    "integral_bytes_total",
    "Bytes of the most recently published integral artifact, per "
    "pyramid level",
    labelnames=("level",))
