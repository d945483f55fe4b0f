"""Incident bundles: flush the flight recorder on failure edges.

The port's copy of heatmap_tpu/obs/incident.py (stdlib only): the same
behaviour for the same calls.

A **trigger** — SLO breach rising edge, typed-503 shed, injected-fault
storm over a rate threshold, degraded-enter, a telemetry anomaly edge
(obs/anomaly.py), or an uncaught exception in a CLI job — flushes one
self-contained bundle under ``<incident_dir>/<run_id>-<seq>/``:

- ``trace.json``    ring spans as Perfetto/Chrome trace-event JSON
  (loadable in chrome://tracing and by tools/trace_analyze.py);
- ``events.json``   the recent event tail from the ring;
- ``metrics.json``  full registry snapshot (exemplars included);
- ``telemetry.json`` the raw-tier time-series window preceding the
  trigger (when a telemetry store is installed) — the "what changed
  in the last 5 minutes" a point-in-time snapshot cannot answer;
- ``state.json``    whatever state providers are registered —
  /healthz + breaker/fleet state from serve, config fingerprint and
  delta/synopsis epochs from the CLI;
- ``manifest.json`` envelope: trigger, detail, run_id/seq, per-file
  bytes, recorder stats.

Bundles are **atomic** (written to a dot-tmp sibling then renamed),
**rate-limited** per trigger kind (``min_interval_s`` on an injectable
clock so tests and chaos_soak pin exact bundle counts), **size-capped**
(event/span tails are trimmed oldest-first until the serialized bundle
fits ``max_bytes``), and **pruned** with the same age-wins retention
discipline as delta/recover.py quarantine: keep the newest ``keep``
bundles, but never delete one younger than ``min_age_s`` — age wins
over count, so a burst cannot evict the bundle you are reading.

Module-level state mirrors the event-log pattern: ``set_manager``
installs the process-wide manager and wires it as the recorder's
event hook; :func:`trigger` no-ops when none is installed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from collections import deque

DEFAULT_KEEP = 16
DEFAULT_MIN_AGE_S = 300.0
DEFAULT_MIN_INTERVAL_S = 30.0
DEFAULT_MAX_BYTES = 4_000_000
DEFAULT_EVENT_TAIL = 400
DEFAULT_STORM_THRESHOLD = 8
DEFAULT_STORM_WINDOW_S = 10.0

TRIGGER_KINDS = ("slo_breach", "shed", "fault_storm", "degraded_enter",
                 "anomaly", "exception")
DEFAULT_TELEMETRY_WINDOW_S = 300.0


class IncidentManager:
    """Owns the incident directory: trigger edges in, bundles out."""

    def __init__(self, out_dir: str, *, run_id: str | None = None,
                 keep: int = DEFAULT_KEEP,
                 min_age_s: float = DEFAULT_MIN_AGE_S,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 event_tail: int = DEFAULT_EVENT_TAIL,
                 storm_threshold: int = DEFAULT_STORM_THRESHOLD,
                 storm_window_s: float = DEFAULT_STORM_WINDOW_S,
                 clock=time.time):
        self.out_dir = out_dir
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.keep = int(keep)
        self.min_age_s = float(min_age_s)
        self.min_interval_s = float(min_interval_s)
        self.max_bytes = int(max_bytes)
        self.event_tail = int(event_tail)
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._last_flush: dict[str, float] = {}
        self._fault_ts: deque = deque(maxlen=1024)
        self._providers: dict = {}
        self.flushed: list[str] = []
        self.suppressed = 0
        os.makedirs(out_dir, exist_ok=True)

    # -- state providers ---------------------------------------------------
    def add_state_provider(self, name: str, fn):
        """Register a callable folded into the bundle's state.json
        (serve /healthz, fleet breakers, config fingerprint...)."""
        with self._lock:
            self._providers[str(name)] = fn

    # -- trigger detection over the event stream ---------------------------
    def on_event(self, rec: dict):
        """Recorder event hook: turn failure-edge events into flushes.
        slo_breach and degraded_enter are already edge-triggered at
        their source (one record per episode); fault storms are
        detected here over the events' own wall-clock timestamps so a
        seeded chaos replay detects the same storms."""
        event = rec.get("event")
        if event == "slo_breach":
            self.trigger("slo_breach", detail=rec.get("slo"))
        elif event == "degraded_enter":
            self.trigger("degraded_enter", detail=rec.get("cause"))
        elif event == "anomaly_detected":
            self.trigger("anomaly", detail=rec.get("series"))
        elif event == "fault_injected":
            ts = rec.get("ts", 0.0)
            storm = False
            with self._lock:
                self._fault_ts.append(ts)
                window = [t for t in self._fault_ts
                          if ts - t <= self.storm_window_s]
                if len(window) >= self.storm_threshold:
                    storm = True
                    self._fault_ts.clear()  # next episode starts fresh
            if storm:
                self.trigger("fault_storm", detail=rec.get("site"))

    # -- flushing ----------------------------------------------------------
    def trigger(self, kind: str, detail=None) -> str | None:
        """Flush one bundle for a trigger edge; returns its path, or
        None when the per-kind rate limit suppressed it."""
        now = self._clock()
        with self._lock:
            last = self._last_flush.get(kind)
            if last is not None and (now - last) < self.min_interval_s:
                self.suppressed += 1
                return None
            self._last_flush[kind] = now
            seq = self._seq
            self._seq += 1
        path = self._flush(kind, detail, seq, now)
        from heatmap_tpu_torch.obs import INCIDENTS_TOTAL, events

        INCIDENTS_TOTAL.inc(trigger=kind)
        events.emit("incident_flush", trigger=kind, path=path,
                    seq=seq, detail=None if detail is None else str(detail))
        return path

    def _flush(self, kind: str, detail, seq: int, now: float) -> str:
        from heatmap_tpu_torch.obs import recorder as recorder_mod
        from heatmap_tpu_torch.obs import metrics, tracing

        rcd = recorder_mod.get_recorder()
        spans = rcd.span_records() if rcd is not None else []
        tail = (rcd.event_records() if rcd is not None else [])
        tail = tail[-self.event_tail:]
        collector = tracing.get_collector()
        if collector is not None:
            t0 = collector.t0
        else:
            t0 = min((s["start_s"] for s in spans), default=0.0)
        with self._lock:
            providers = dict(self._providers)
        state = {}
        for name, fn in sorted(providers.items()):
            try:
                state[name] = fn()
            except Exception as e:  # a dying subsystem must not block
                state[name] = {"error": repr(e)}

        # Recent telemetry history (obs/timeseries.py): the raw-tier
        # window preceding the trigger, so the bundle answers "what
        # changed in the 5 minutes before this fired" — not just the
        # instantaneous metrics.json snapshot. Bounded by the store's
        # own rings, so it rides outside the trim loop.
        from heatmap_tpu_torch.obs import timeseries

        ts_store = timeseries.get_store()
        telemetry = (ts_store.recent_window(DEFAULT_TELEMETRY_WINDOW_S)
                     if ts_store is not None else None)

        # Size cap: trim the tails oldest-first until the bundle fits.
        files = None
        while True:
            files = {
                "trace.json": json.dumps(
                    tracing.chrome_doc(spans, t0), default=str),
                "events.json": json.dumps(tail, default=str),
                "metrics.json": json.dumps(
                    metrics.get_registry().snapshot(), indent=1,
                    sort_keys=True, default=str),
                "state.json": json.dumps(state, indent=1, sort_keys=True,
                                         default=str),
            }
            if telemetry is not None:
                files["telemetry.json"] = json.dumps(
                    telemetry, sort_keys=True, default=str)
            total = sum(len(v) for v in files.values())
            if total <= self.max_bytes or (not spans and not tail):
                break
            if len(tail) >= len(spans):
                tail = tail[len(tail) // 2 + 1:]
            else:
                spans = spans[len(spans) // 2 + 1:]

        manifest = {
            "run_id": self.run_id, "seq": seq, "trigger": kind,
            "detail": None if detail is None else str(detail),
            "ts": now, "bytes": total,
            "files": {name: len(body) for name, body in files.items()},
            "recorder": rcd.stats() if rcd is not None else None,
            "trace_dropped": (collector.dropped if collector is not None
                              else None),
        }
        files["manifest.json"] = json.dumps(manifest, indent=1,
                                            sort_keys=True, default=str)

        name = f"{self.run_id}-{seq}"
        tmp = os.path.join(self.out_dir, f".tmp-{name}")
        final = os.path.join(self.out_dir, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for fname, body in files.items():
            with open(os.path.join(tmp, fname), "w") as f:
                f.write(body)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self.flushed.append(final)
        self.prune(now=now)
        return final

    # -- retention ---------------------------------------------------------
    def prune(self, now: float | None = None) -> dict:
        """Age-wins retention (the delta/recover.py quarantine
        discipline): keep the newest ``keep`` bundles; beyond that,
        delete — unless the bundle is younger than ``min_age_s``."""
        if now is None:
            now = self._clock()
        entries = []
        try:
            names = os.listdir(self.out_dir)
        except OSError:
            return {"pruned": 0, "kept": 0}
        for name in names:
            full = os.path.join(self.out_dir, name)
            if name.startswith(".tmp-") or not os.path.isdir(full):
                continue
            try:
                mtime = os.path.getmtime(full)
            except OSError:
                continue
            entries.append((mtime, name, full))
        entries.sort(reverse=True)  # newest first
        pruned = 0
        for mtime, _name, full in entries[self.keep:]:
            if (now - mtime) < self.min_age_s:
                continue  # age wins over count
            shutil.rmtree(full, ignore_errors=True)
            pruned += 1
        return {"pruned": pruned, "kept": len(entries) - pruned}


# -- process-wide default manager -------------------------------------------

_manager: IncidentManager | None = None


def set_manager(manager: IncidentManager | None):
    """Install (or clear) the default manager and wire it into the
    recorder's event dispatch so failure-edge events reach it."""
    global _manager
    _manager = manager
    from heatmap_tpu_torch.obs import recorder as recorder_mod

    recorder_mod._incident_hook = (manager.on_event
                                   if manager is not None else None)
    recorder_mod._sync_hooks()


def get_manager() -> IncidentManager | None:
    return _manager


def trigger(kind: str, detail=None) -> str | None:
    """Flush on the default manager; no-op (None) when none installed."""
    manager = _manager
    if manager is None:
        return None
    return manager.trigger(kind, detail=detail)


def add_state_provider(name: str, fn):
    """Register a provider on the default manager (no-op when none)."""
    manager = _manager
    if manager is not None:
        manager.add_state_provider(name, fn)
