"""Flight recorder: always-on bounded rings of completed spans/events.

The port's copy of heatmap_tpu/obs/recorder.py (stdlib only): the same
behaviour for the same calls.

Head sampling (obs/tracing.py) decides keep-or-drop once at the trace
root, so a 503 burst or a straggler inside an unsampled trace is lost
forever. The :class:`FlightRecorder` closes that gap with **tail-based
retention**: while installed it keeps the last N *completed* spans and
events per subsystem at full fidelity regardless of the head decision
(unsampled trees run as "shadow" spans — real Span objects flagged so
they never reach the collector or render a sampled traceparent), and
when a tree turns out to matter — an error, a 5xx, an injected fault,
or latency past the tail threshold — :meth:`FlightRecorder.promote`
copies the whole tree out of the ring into the trace collector exactly
as if it had been head-sampled (records are the same ``to_record``
dicts, so promotion is byte-for-byte), dedup'd against already-sampled
roots (sampled spans are never shadow, so there is nothing to copy).

Integration mirrors the rest of obs: one module-global hook per
integration point (``tracing._recorder`` for span routing,
``events._recorder`` for the event ring + incident trigger dispatch),
all None unless :func:`install` wired them, so the off path stays one
global read. No clocks live here — spans carry their own start/dur
and event records carry wall-clock ``ts`` (tests/test_obs.py greps
this file for banned timing calls).
"""

from __future__ import annotations

import threading
from collections import deque

DEFAULT_MAX_SPANS = 256
DEFAULT_MAX_EVENTS = 512


class FlightRecorder:
    """Bounded, lock-cheap ring of completed spans/events per subsystem.

    ``max_spans`` / ``max_events`` bound each subsystem's ring (the
    subsystem is the span name's first dotted segment, e.g.
    ``serve.request`` -> ``serve``; for events the name's first ``_``
    token, e.g. ``http_request`` -> ``http``). Evictions are counted in
    ``dropped`` (and the ``recorder_dropped_total`` counter when the
    registry is live) — the ring never grows without bound.
    """

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 tail_latency_s: float | None = None):
        if max_spans <= 0 or max_events <= 0:
            raise ValueError("ring capacities must be positive")
        self.max_spans = int(max_spans)
        self.max_events = int(max_events)
        self.tail_latency_s = (None if tail_latency_s is None
                               else float(tail_latency_s))
        self._lock = threading.Lock()
        self._span_rings: dict[str, deque] = {}
        self._event_rings: dict[str, deque] = {}
        # trace_id -> [(shadow, rec), ...] for every span still in a
        # ring (evictions remove their entry, so promotion only ever
        # copies what the ring actually holds).
        self._by_trace: dict[str, list] = {}
        self._promote: set = set()    # live trees being routed out
        self._promoted: set = set()   # dedup: one promotion per trace
        self.dropped = 0
        self.promoted_spans = 0

    # -- capture -----------------------------------------------------------
    @staticmethod
    def _span_subsystem(name: str) -> str:
        return name.split(".", 1)[0]

    @staticmethod
    def _event_subsystem(event: str) -> str:
        return event.split("_", 1)[0]

    def record_span(self, span):
        """Span-close hook (tracing.end_span): ring the completed span;
        forward it live when its tree was already promoted."""
        rec = span.to_record()
        shadow = span.shadow
        entry = (shadow, rec)
        forward = False
        evicted = 0
        with self._lock:
            ring = self._span_rings.get(self._span_subsystem(span.name))
            if ring is None:
                ring = deque()
                self._span_rings[self._span_subsystem(span.name)] = ring
            if len(ring) >= self.max_spans:
                old = ring.popleft()
                evicted = 1
                peers = self._by_trace.get(old[1]["trace_id"])
                if peers is not None:
                    try:
                        peers.remove(old)
                    except ValueError:
                        pass
                    if not peers:
                        del self._by_trace[old[1]["trace_id"]]
            ring.append(entry)
            self._by_trace.setdefault(rec["trace_id"], []).append(entry)
            if shadow and rec["trace_id"] in self._promote:
                forward = True
        if evicted:
            self._count_dropped(evicted)
        if forward:
            self._forward([rec])

    def record_event(self, rec: dict):
        """Event hook (via _dispatch_event): ring the record; an
        injected fault promotes its ambient tree."""
        event = rec.get("event", "")
        evicted = 0
        with self._lock:
            ring = self._event_rings.get(self._event_subsystem(event))
            if ring is None:
                ring = deque()
                self._event_rings[self._event_subsystem(event)] = ring
            if len(ring) >= self.max_events:
                ring.popleft()
                evicted = 1
            ring.append(dict(rec))
        if evicted:
            self._count_dropped(evicted)
        if event == "fault_injected":
            trace_id = rec.get("trace_id")
            if trace_id:
                self.promote(trace_id)

    def _count_dropped(self, n: int):
        self.dropped += n
        from heatmap_tpu_torch.obs import RECORDER_DROPPED

        RECORDER_DROPPED.inc(n)

    # -- tail-based retention ----------------------------------------------
    def promote(self, trace_id: str) -> int:
        """Copy a tree's shadow spans from the ring into the collector
        as if head-sampled. Idempotent per trace (the dedup against
        already-promoted and head-sampled roots); spans that complete
        after promotion are forwarded live. Returns spans copied now."""
        with self._lock:
            if trace_id in self._promoted:
                return 0
            self._promoted.add(trace_id)
            self._promote.add(trace_id)
            recs = [rec for shadow, rec in self._by_trace.get(trace_id, ())
                    if shadow]
        if recs:
            self._forward(recs)
        return len(recs)

    def _forward(self, recs):
        from heatmap_tpu_torch.obs import tracing

        collector = tracing.get_collector()
        if collector is None:
            return
        for rec in recs:
            collector.add_record(rec)
        self.promoted_spans += len(recs)

    # -- snapshots (incident bundles, tests) -------------------------------
    def span_records(self) -> list:
        """Every span currently ringed, oldest-first per subsystem."""
        with self._lock:
            return [rec for sub in sorted(self._span_rings)
                    for _shadow, rec in self._span_rings[sub]]

    def event_records(self) -> list:
        """Every event currently ringed, ordered by envelope (ts, seq)
        so the bundle tail reads like the log it came from."""
        with self._lock:
            recs = [rec for sub in sorted(self._event_rings)
                    for rec in self._event_rings[sub]]
        recs.sort(key=lambda r: (r.get("ts", 0.0), r.get("seq", -1)))
        return recs

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_spans": self.max_spans,
                "max_events": self.max_events,
                "tail_latency_s": self.tail_latency_s,
                "spans": sum(len(r) for r in self._span_rings.values()),
                "events": sum(len(r) for r in self._event_rings.values()),
                "subsystems": sorted(set(self._span_rings)
                                     | set(self._event_rings)),
                "dropped": self.dropped,
                "promoted_traces": len(self._promoted),
                "promoted_spans": self.promoted_spans,
            }

    def clear(self):
        with self._lock:
            self._span_rings.clear()
            self._event_rings.clear()
            self._by_trace.clear()
            self._promote.clear()
            self._promoted.clear()
            self.dropped = 0
            self.promoted_spans = 0


# -- module state / hooks ---------------------------------------------------

_recorder: FlightRecorder | None = None
# Installed by obs.incident.set_manager: sees every emitted event record
# (trigger detection) without events.py importing either module.
_incident_hook = None


def _dispatch_event(rec: dict):
    """The single events._recorder hook: feed the ring, then the
    incident trigger engine."""
    rcd = _recorder
    if rcd is not None:
        rcd.record_event(rec)
    hook = _incident_hook
    if hook is not None:
        hook(rec)


def _sync_hooks():
    """Point the tracing/events hooks at current state (None when
    neither a recorder nor an incident manager is installed, restoring
    the zero-cost off path)."""
    from heatmap_tpu_torch.obs import events, tracing

    events._recorder = (_dispatch_event if (_recorder is not None
                                            or _incident_hook is not None)
                        else None)
    tracing._recorder = _recorder


def install(recorder: FlightRecorder | None):
    """Install (or clear, with None) the process-wide flight recorder
    and wire the tracing/events hooks."""
    global _recorder
    _recorder = recorder
    _sync_hooks()


def get_recorder() -> FlightRecorder | None:
    return _recorder


def maybe_promote(span=None, *, status=None, error: bool = False,
                  ms: float | None = None,
                  trace_id: str | None = None) -> bool:
    """Promote the (ambient or given) tree when it completed badly:
    an error, a 5xx status, or latency past the recorder's tail
    threshold. No-op (False) when no recorder is installed or nothing
    qualified. Call *before* end_span on the root so the root itself
    rides the live-forward path."""
    recorder = _recorder
    if recorder is None:
        return False
    if trace_id is None:
        if span is None:
            from heatmap_tpu_torch.obs import tracing

            span = tracing._current.get()
        trace_id = getattr(span, "trace_id", None)
    if trace_id is None:
        return False
    bad = error or (status is not None and int(status) >= 500)
    if not bad and ms is not None and recorder.tail_latency_s is not None:
        bad = (ms / 1000.0) >= recorder.tail_latency_s
    if not bad:
        return False
    recorder.promote(trace_id)
    return True
