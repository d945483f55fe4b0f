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
tracing is on and costs a nullcontext otherwise.

Closed spans of the default tracer also feed the telemetry core
(heatmap_tpu_torch/obs): a ``stage_duration_seconds`` sample and a
``stage_end`` event, both no-ops unless a metrics sink or an event log
is configured, and a node of the span tree while ``obs.enable_tracing``
has hooked it in. ``torch_profile(logdir)`` is the port's twin of the
JAX package's ``jax_profile`` (``run --profile LOGDIR``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

_obs = None  # imported at the first span close, not with this module

# Span-tree hooks, installed by obs.tracing.enable_tracing (and removed
# by disable_tracing). While set, every default-tracer span also opens a
# node in the hierarchical trace; with tracing off the cost is one
# global read.
_tree_begin = None
_tree_end = None


def _obs_record(name: str, wall_s: float, items, attrs: dict):
    global _obs
    if _obs is None:
        from heatmap_tpu_torch import obs

        _obs = obs
    _obs.record_stage(name, wall_s, items=items, **attrs)


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
        # Set by torch_profile when the profiler cannot start; surfaced
        # in obs.report.build_run_report's warnings.
        self.profiler_warning: str | None = None

    def _stat(self, name: str) -> _SpanStats:
        s = self._stats.get(name)
        if s is None:
            s = self._stats.setdefault(name, _SpanStats())
        return s

    @contextlib.contextmanager
    def span(self, name: str, items: int | None = None, **attrs):
        """Time the body under ``name``. Keyword ``attrs`` (e.g.
        ``backend="partitioned"``) ride along on the stage_end event when
        an event log is installed."""
        begin = _tree_begin
        tree_span = (begin(name, attrs or None)
                     if begin is not None and self is _default else None)
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
            if self is _default:
                # stage_end emits while the tree span is still ambient,
                # so the event carries this span's identity.
                _obs_record(name, dt, items, attrs)
            if tree_span is not None:
                end = _tree_end
                if end is not None:  # may be unhooked mid-span in tests
                    end(tree_span)

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
            self.profiler_warning = None

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


@contextlib.contextmanager
def torch_profile(logdir: str):
    """Capture a ``torch.profiler`` trace of the body (host ops and, on a
    card, its kernels) into ``logdir/trace.json``, a Chrome/Perfetto
    trace-event file.

    When the profiler cannot start or write, the body still runs: the
    failure is recorded on ``get_tracer().profiler_warning`` and, when an
    event log is installed, as a ``profiler_unavailable`` event; both
    surface in the run report's warnings.
    """
    import torch

    from heatmap_tpu_torch.obs import events

    def _unavailable(e):
        _default.profiler_warning = (
            f"torch profiler unavailable ({type(e).__name__}: {e}); "
            f"no trace written to {logdir}")
        events.emit("profiler_unavailable", error=repr(e),
                    logdir=str(logdir))

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.__enter__()
    except (RuntimeError, OSError) as e:
        _unavailable(e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except (RuntimeError, OSError) as e:
                _unavailable(e)
