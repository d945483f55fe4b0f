"""Host wall-clock spans and throughput counters.

The port's copy of the ``Tracer`` of heatmap_tpu/utils/trace.py: a
process-wide tracer records, per span name, the count, total and
largest wall time and the items processed, so ``report()`` yields
items per second. The batch job's chunked, fast and resumable paths
record into it (``ingest.batch``, ``cascade.chunk``, ``merge.chunk``,
``egress.*``, ``checkpoint``).

Spans measure the host's clock. Device work inside a span is counted
only as far as the host waited for it; ``devices.StageTimer`` is the
fenced per-stage split. ``stage_span`` opens a span only while stage
tracing is on and costs a nullcontext otherwise. The JAX package's
telemetry hooks and its ``jax_profile`` are left out with its obs core.
"""

from __future__ import annotations

import contextlib
import threading
import time


class _SpanStats:
    __slots__ = ("count", "total_s", "max_s", "items")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.items = 0


class Tracer:
    """Per-name span statistics + item throughput, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, _SpanStats] = {}

    def _stat(self, name: str) -> _SpanStats:
        s = self._stats.get(name)
        if s is None:
            s = self._stats.setdefault(name, _SpanStats())
        return s

    @contextlib.contextmanager
    def span(self, name: str, items: int | None = None, **attrs):
        """Time the body under ``name``. Keyword ``attrs`` are accepted
        for call-site parity with the JAX package and not recorded."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._stat(name)
                s.count += 1
                s.total_s += dt
                s.max_s = max(s.max_s, dt)
                if items:
                    s.items += int(items)

    def add_items(self, name: str, n: int):
        """Attribute ``n`` processed items to ``name`` (throughput)."""
        with self._lock:
            self._stat(name).items += int(n)

    def report(self) -> dict:
        """{name: {count, total_s, max_s, mean_s, items, items_per_s}}."""
        out = {}
        with self._lock:
            for name, s in self._stats.items():
                out[name] = {
                    "count": s.count,
                    "total_s": s.total_s,
                    "max_s": s.max_s,
                    "mean_s": s.total_s / s.count if s.count else 0.0,
                    "items": s.items,
                    "items_per_s": s.items / s.total_s if s.total_s else 0.0,
                }
        return out

    def reset(self):
        with self._lock:
            self._stats.clear()

    def format_report(self) -> str:
        lines = []
        for name, r in sorted(self.report().items()):
            line = (
                f"{name:<28} n={r['count']:<6} total={r['total_s']:.3f}s "
                f"mean={r['mean_s'] * 1e3:.2f}ms max={r['max_s'] * 1e3:.2f}ms"
            )
            if r["items"]:
                line += (
                    f" items={r['items']} ({r['items_per_s'] / 1e6:.2f} M/s)"
                )
            lines.append(line)
        return "\n".join(lines)


_default = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer the pipeline records into."""
    return _default


def span(name: str, items: int | None = None, **attrs):
    """Span on the default tracer: ``with span("binning", items=n): ...``"""
    return _default.span(name, items=items, **attrs)


_stage_tracing = False


def enable_stage_tracing(on: bool = True):
    global _stage_tracing
    _stage_tracing = on


def stage_tracing_enabled() -> bool:
    return _stage_tracing


def stage_span(name: str, items: int | None = None, **attrs):
    """A default-tracer span only under stage tracing; a nullcontext
    otherwise, so hot call sites pay nothing when it is off."""
    if not _stage_tracing:
        return contextlib.nullcontext()
    return _default.span(name, items=items, **attrs)
