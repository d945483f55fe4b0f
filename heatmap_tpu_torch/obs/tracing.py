"""Hierarchical distributed tracing: span trees over the flat tracer.

The port's copy of heatmap_tpu/obs/tracing.py. ``obs.recorder.install``
sets the flight-recorder hook ``_recorder``.

The flat tracer answers "how much time did stage X take in aggregate";
this module answers "where did *this* request or *this* delta apply
spend its time". Every recorded span carries an identity triple
(``trace_id`` / ``span_id`` / ``parent_id``) and spans nest through a
``contextvars.ContextVar``, so one serve request or one journaled apply
produces a single connected tree even when the work hops threads
(``context_bound`` re-binds the ambient span into pool workers, which
otherwise start with an empty context).

Design points:

- **Root-on-demand.** A span opened with no ambient parent becomes the
  root of a new trace; the sampling decision (``sample`` probability,
  or an incoming ``traceparent``'s flags) is made once at the root and
  inherited by every descendant. Unsampled roots install a sentinel so
  descendants are near-free no-ops rather than new roots.
- **Zero-cost when off.** The hot-path guard is one module-global read
  (``_on``); ``utils.trace`` and ``obs.events`` integrate through
  hooks installed by :func:`enable_tracing` and removed by
  :func:`disable_tracing`, so neither pays an import or an attribute
  chain while tracing is disabled. Blob output is pinned byte-identical
  with tracing on vs off (tests/test_obs.py).
- **W3C-style propagation.** ``current_traceparent()`` renders the
  ambient span as ``00-{trace_id}-{span_id}-{flags}``; the serve tier
  accepts the same header on requests and multihost heartbeats carry it
  as an event field, so cross-process trees share one trace_id.
- **Chrome/Perfetto export.** ``export_chrome`` writes the collected
  spans as trace-event JSON (``ph: "X"`` complete events, microsecond
  ``ts``/``dur``) loadable in ``chrome://tracing`` / Perfetto and by
  ``tools/trace_analyze.py`` (critical path + self-time attribution).

All timing goes through ``_now_s`` — the module's single sanctioned
clock site (tests/test_obs.py greps this file).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
import uuid

# Hard cap on buffered finished spans; beyond it spans are counted as
# dropped instead of growing without bound (a long-lived serve process
# with sample=1.0 would otherwise leak).
MAX_SPANS = 100_000

TRACEPARENT_VERSION = "00"
FLAG_SAMPLED = 0x01


def _now_s() -> float:
    return time.perf_counter()  # sanctioned: the module's only clock site


class Span:
    """One node of a trace tree. Identity is fixed at creation; the
    duration is fixed by :meth:`finish` (collector-relative monotonic
    seconds, exported as microseconds)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "dur_s", "attrs", "tid", "shadow", "_token")

    def __init__(self, name: str, trace_id: str, parent_id: str | None,
                 attrs: dict | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.start_s = _now_s()
        self.dur_s = 0.0
        self.attrs = attrs or {}
        self.tid = threading.get_ident()
        # Shadow spans run under an unsampled root while the flight
        # recorder is installed: full fidelity into the ring, never the
        # collector (unless the tree is promoted), flags 00 on the wire.
        self.shadow = False
        self._token = None

    def to_record(self) -> dict:
        """Plain-dict form (what export/analysis consume)."""
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_s": self.start_s, "dur_s": self.dur_s,
                "tid": self.tid, "attrs": dict(self.attrs)}


class _NotSampled:
    """Contextvar sentinel under an unsampled root: descendants see it
    and no-op instead of opening fresh roots."""

    __slots__ = ("trace_id", "span_id", "_token")

    def __init__(self, trace_id: str | None = None,
                 span_id: str | None = None):
        self.trace_id = trace_id or uuid.uuid4().hex
        self.span_id = span_id or uuid.uuid4().hex[:16]
        self._token = None


def chrome_doc(records, t0: float = 0.0) -> dict:
    """Render span records as a Chrome/Perfetto trace-event document
    (shared by the collector export and incident bundles)."""
    pid = os.getpid()
    events = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "heatmap_tpu"},
    }]
    for rec in records:
        args = {"trace_id": rec["trace_id"],
                "span_id": rec["span_id"],
                "parent_id": rec["parent_id"]}
        for k, v in rec["attrs"].items():
            args[k] = v if isinstance(v, (int, float, bool, str,
                                          type(None))) else str(v)
        events.append({
            "name": rec["name"], "cat": "heatmap", "ph": "X",
            "ts": round((rec["start_s"] - t0) * 1e6, 3),
            "dur": round(rec["dur_s"] * 1e6, 3),
            "pid": pid, "tid": rec["tid"], "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class TraceCollector:
    """Thread-safe buffer of finished spans plus the sampling policy."""

    def __init__(self, sample: float = 1.0, seed: int | None = None):
        if not (0.0 <= sample <= 1.0):
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.sample = float(sample)
        self.t0 = _now_s()
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: list[dict] = []
        self._rng = random.Random(seed)

    def sample_decision(self) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return self._rng.random() < self.sample

    def add(self, span: Span):
        self.add_record(span.to_record())

    def add_record(self, rec: dict):
        """Buffer an already-materialised span record (what the flight
        recorder's tail promotion forwards — byte-for-byte the dict a
        head-sampled span would have contributed)."""
        with self._lock:
            if len(self._spans) >= MAX_SPANS:
                self.dropped += 1
                return
            self._spans.append(rec)

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (``ph:"X"`` complete events, µs)."""
        return chrome_doc(self.spans(), self.t0)

    def export_chrome(self, path: str) -> int:
        """Write trace-event JSON; returns the number of span events."""
        doc = self.to_chrome()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return len(doc["traceEvents"]) - 1

    def summary(self, max_roots: int = 5) -> dict:
        """Compact digest for run reports / bench records: root spans
        ranked by duration plus totals."""
        spans = self.spans()
        roots = [s for s in spans if s["parent_id"] is None]
        roots.sort(key=lambda s: -s["dur_s"])
        per_trace: dict[str, int] = {}
        for s in spans:
            per_trace[s["trace_id"]] = per_trace.get(s["trace_id"], 0) + 1
        return {
            "n_spans": len(spans),
            "n_traces": len(per_trace),
            "dropped": self.dropped,
            "roots": [{"name": r["name"], "trace_id": r["trace_id"],
                       "wall_s": round(r["dur_s"], 6),
                       "n_spans": per_trace.get(r["trace_id"], 0)}
                      for r in roots[:max_roots]],
        }


# -- module state ----------------------------------------------------------

_on = False  # THE hot-path guard: one global read when tracing is off
_collector: TraceCollector | None = None
# Installed by obs.recorder.install: routes shadow spans (unsampled
# trees captured at full fidelity) into the flight-recorder ring.
_recorder = None
_current: contextvars.ContextVar = contextvars.ContextVar(
    "heatmap_tpu_span", default=None)


def enable_tracing(sample: float = 1.0,
                   seed: int | None = None) -> TraceCollector:
    """Install a collector and hook the tracer + event log onto the
    tree. Returns the collector (export/summary handle)."""
    global _on, _collector
    _collector = TraceCollector(sample=sample, seed=seed)
    _on = True
    from heatmap_tpu_torch.obs import events, metrics
    from heatmap_tpu_torch.utils import trace

    trace._tree_begin = begin_span
    trace._tree_end = end_span
    events._trace_ids = current_ids
    metrics._exemplar_ids = current_ids
    return _collector


def disable_tracing():
    """Remove the collector and unhook integrations (reset helper)."""
    global _on, _collector
    _on = False
    _collector = None
    from heatmap_tpu_torch.obs import events, metrics
    from heatmap_tpu_torch.utils import trace

    trace._tree_begin = None
    trace._tree_end = None
    events._trace_ids = None
    metrics._exemplar_ids = None


def tracing_enabled() -> bool:
    return _on


def get_collector() -> TraceCollector | None:
    return _collector


def current_span() -> Span | None:
    """The ambient span, or None (off / no root / unsampled root)."""
    if not _on:
        return None
    cur = _current.get()
    return cur if isinstance(cur, Span) else None


def current_ids() -> tuple | None:
    """(trace_id, span_id) of the ambient span — the event-stamping
    hook installed on obs.events."""
    sp = current_span()
    if sp is None:
        return None
    return (sp.trace_id, sp.span_id)


# -- span lifecycle --------------------------------------------------------

def begin_span(name: str, attrs: dict | None = None,
               traceparent: str | None = None):
    """Open a span under the ambient context (root-on-demand).

    Returns a Span, a _NotSampled sentinel (caller must still pass it
    to end_span so the contextvar unwinds), or None when tracing is
    off. ``traceparent`` (only meaningful for roots) continues a remote
    trace and overrides the probabilistic sampling decision with the
    header's sampled flag.
    """
    collector = _collector
    if not _on or collector is None:
        return None
    parent = _current.get()
    if isinstance(parent, _NotSampled):
        if _recorder is None:
            return None  # whole subtree is unsampled; nothing to unwind
        # Flight recorder installed: capture the unsampled subtree at
        # full fidelity as shadow spans (ring-bound, promotable).
        sp = Span(name, parent.trace_id, parent.span_id, attrs)
        sp.shadow = True
    elif parent is None:
        # Root: decide sampling here, once per trace.
        remote = parse_traceparent(traceparent) if traceparent else None
        if remote is not None:
            trace_id, parent_id, sampled = remote
        else:
            trace_id, parent_id = uuid.uuid4().hex, None
            sampled = collector.sample_decision()
        if not sampled:
            if _recorder is None:
                sentinel = _NotSampled(trace_id)
                sentinel._token = _current.set(sentinel)
                return sentinel
            sp = Span(name, trace_id, parent_id, attrs)
            sp.shadow = True
        else:
            sp = Span(name, trace_id, parent_id, attrs)
    else:
        sp = Span(name, parent.trace_id, parent.span_id, attrs)
        sp.shadow = parent.shadow
    sp._token = _current.set(sp)
    return sp


def end_span(sp):
    """Close a span from begin_span: fix duration, unwind the
    contextvar, hand the record to the collector."""
    if sp is None:
        return
    if sp._token is not None:
        _current.reset(sp._token)
        sp._token = None
    if isinstance(sp, _NotSampled):
        return
    sp.dur_s = _now_s() - sp.start_s
    recorder = _recorder
    if sp.shadow:
        # Shadow spans never reach the collector directly; the ring
        # forwards them on tail promotion.
        if recorder is not None:
            recorder.record_span(sp)
        return
    collector = _collector
    if collector is not None:
        collector.add(sp)
    if recorder is not None:
        recorder.record_span(sp)


@contextlib.contextmanager
def span(name: str, traceparent: str | None = None, **attrs):
    """``with tracing.span("serve.request"): ...`` — yields the Span
    (or None when off/unsampled). Roots honor ``traceparent``."""
    sp = begin_span(name, attrs or None, traceparent=traceparent)
    try:
        yield sp if isinstance(sp, Span) else None
    finally:
        end_span(sp)


def context_bound(fn):
    """Bind ``fn`` to the caller's context so the ambient span survives
    into executor worker threads (which otherwise start with an empty
    context). Returns ``fn`` untouched when tracing is off."""
    if not _on:
        return fn
    ctx = contextvars.copy_context()

    def _bound(*args, **kwargs):
        return ctx.run(fn, *args, **kwargs)

    return _bound


# -- traceparent propagation ----------------------------------------------

def current_traceparent() -> str | None:
    """Render the ambient span (sampled or not) as a W3C-style
    ``00-{trace_id}-{span_id}-{flags}`` header, or None."""
    if not _on:
        return None
    cur = _current.get()
    if cur is None:
        return None
    # Shadow spans are real Spans but head-UNSAMPLED: downstream must
    # see flags 00 or remote hops would head-sample the continuation.
    flags = (FLAG_SAMPLED if isinstance(cur, Span) and not cur.shadow
             else 0)
    return (f"{TRACEPARENT_VERSION}-{cur.trace_id}-{cur.span_id}-"
            f"{flags:02x}")


def parse_traceparent(header: str | None):
    """``(trace_id, parent_span_id, sampled)`` or None on malformed
    input (malformed headers start a fresh local trace, never raise)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        sampled = bool(int(flags, 16) & FLAG_SAMPLED)
    except ValueError:
        return None
    return (trace_id, span_id, sampled)
