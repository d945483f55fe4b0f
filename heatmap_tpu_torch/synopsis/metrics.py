"""Synopsis metric handles on the shared obs registry (the port's copy
of heatmap_tpu/synopsis/metrics.py).

Module-level, created once at import (the delta/metrics.py pattern):
handles survive ``registry.reset()`` between tests and self-gate on
``registry.enabled``. Semantics are documented in
docs/observability.md.
"""

from __future__ import annotations

from heatmap_tpu_torch import obs

_registry = obs.get_registry()

SYNOPSIS_BYTES = _registry.counter(
    "synopsis_bytes_total",
    "Bytes of synopsis artifacts published, per pyramid level",
    labelnames=("level",))
SYNOPSIS_DECODE_SECONDS = _registry.histogram(
    "synopsis_decode_seconds",
    "Wall-clock of decoding one synopsis level (inverse Haar + extras) "
    "into a servable index",
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0))
SYNOPSIS_MAX_ERROR = _registry.gauge(
    "synopsis_max_error",
    "Stamped L-inf error bound of the most recently published synopsis, "
    "per pyramid level (achieved worst cell error across pairs)",
    labelnames=("level",))
