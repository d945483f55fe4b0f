"""Declarative SLOs with error-budget burn rates over the event log.

The port's copy of heatmap_tpu/obs/slo.py (stdlib only): the same
behaviour for the same calls.

An objective is declared as a spec string (CLI ``--slo``, repeatable):

    NAME:KIND:key=value,key=value,...

Kinds (see docs/observability.md for the full grammar):

- ``latency``    — fraction of ``http_request`` events with
  ``ms <= threshold_ms`` (params: ``threshold_ms`` required,
  ``route`` to filter one route family, ``target``, ``window_s``).
- ``error_rate`` — fraction of ``http_request`` events with
  ``status < 500`` (params: ``target``, ``window_s``, ``route``).
- ``staleness``  — the newest ``delta_applied``/``store_reload`` event
  is at most ``max_age_s`` old (params: ``max_age_s`` required,
  ``target``, ``window_s``; compliance is binary).

``target`` defaults to 0.999 and ``window_s`` to 300. The error budget
is ``1 - target``; the burn rate is ``bad_fraction / budget`` — burn 1.0
spends the budget exactly at the window's pace, burn >1 is a breach and
emits one ``slo_breach`` event per rising edge.

The engine consumes events two ways: live, as the observer hook
``obs.events`` calls on every emitted record (serve installs this via
``--slo``), or offline via :func:`SLOEngine.ingest_log` over a finished
run's JSONL (how the run report folds SLO status in). Both feed the
same bounded in-memory window, so ``/healthz`` never re-reads the log
file on the request path.

No raw clocks here beyond ``time.time`` (events carry wall-clock ``ts``
envelopes); tests/test_obs.py greps this file for banned timing calls.
"""

from __future__ import annotations

import threading
import time
from collections import deque

DEFAULT_TARGET = 0.999
DEFAULT_WINDOW_S = 300.0
KINDS = ("latency", "error_rate", "staleness")
_MAX_BUFFER = 10_000
# Events that mark served data as "fresh" for staleness objectives.
# ingest_tick uses the record's wall-clock ts (not the event-time
# watermark it carries — synthetic/replayed streams stamp epoch-scale
# timestamps): a staleness SLO over an ingest loop breaches when no
# tick has completed within max_age_s.
_FRESHNESS_EVENTS = ("delta_applied", "store_reload", "ingest_tick")


class SLOSpec:
    """One parsed objective (immutable after construction)."""

    __slots__ = ("name", "kind", "target", "window_s", "threshold_ms",
                 "max_age_s", "route")

    def __init__(self, name: str, kind: str, *, target: float = DEFAULT_TARGET,
                 window_s: float = DEFAULT_WINDOW_S,
                 threshold_ms: float | None = None,
                 max_age_s: float | None = None, route: str | None = None):
        if kind not in KINDS:
            raise ValueError(f"unknown SLO kind {kind!r} (one of {KINDS})")
        if not name:
            raise ValueError("SLO name must be non-empty")
        if not (0.0 < target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {target}")
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        if kind == "latency" and threshold_ms is None:
            raise ValueError("latency SLO requires threshold_ms=")
        if kind == "staleness" and max_age_s is None:
            raise ValueError("staleness SLO requires max_age_s=")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.window_s = float(window_s)
        self.threshold_ms = None if threshold_ms is None else float(
            threshold_ms)
        self.max_age_s = None if max_age_s is None else float(max_age_s)
        self.route = route

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def describe(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "target": self.target,
             "window_s": self.window_s}
        if self.threshold_ms is not None:
            d["threshold_ms"] = self.threshold_ms
        if self.max_age_s is not None:
            d["max_age_s"] = self.max_age_s
        if self.route is not None:
            d["route"] = self.route
        return d


def parse_slo_spec(spec: str) -> SLOSpec:
    """``NAME:KIND:k=v,...`` -> SLOSpec (raises ValueError with the
    offending fragment on bad input)."""
    parts = spec.split(":", 2)
    if len(parts) < 2:
        raise ValueError(
            f"bad SLO spec {spec!r}: want NAME:KIND[:k=v,...]")
    name, kind = parts[0].strip(), parts[1].strip()
    params: dict = {}
    if len(parts) == 3 and parts[2].strip():
        for item in parts[2].split(","):
            if "=" not in item:
                raise ValueError(
                    f"bad SLO param {item!r} in {spec!r} (want key=value)")
            key, value = item.split("=", 1)
            key = key.strip()
            value = value.strip()
            if key == "route":
                params[key] = value
            elif key in ("target", "window_s", "threshold_ms", "max_age_s"):
                params[key] = float(value)
            else:
                raise ValueError(f"unknown SLO param {key!r} in {spec!r}")
    return SLOSpec(name, kind, **params)


class SLOEngine:
    """Evaluates a set of objectives over a bounded event window.

    Feed it live (``observe``, installed as the obs.events observer) or
    offline (``ingest_log``); ``evaluate`` computes per-objective
    compliance + burn rate and emits ``slo_breach`` on rising edges.
    """

    def __init__(self, specs):
        self.specs = list(specs)
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=_MAX_BUFFER)  # http_request recs
        self._last_fresh: float | None = None  # newest freshness event ts
        self._breaching: set = set()  # objective names currently in breach

    # -- ingestion ---------------------------------------------------------
    def observe(self, rec: dict):
        """Observer hook: called by obs.events.emit for every record."""
        event = rec.get("event")
        if event == "http_request":
            with self._lock:
                self._window.append(
                    (rec.get("ts", 0.0), rec.get("route"),
                     rec.get("status"), rec.get("ms")))
        elif event in _FRESHNESS_EVENTS:
            ts = rec.get("ts", 0.0)
            with self._lock:
                if self._last_fresh is None or ts > self._last_fresh:
                    self._last_fresh = ts

    def ingest_log(self, path: str) -> int:
        """Replay a finished run's JSONL through observe (offline
        folding for the run report). Returns records consumed."""
        from heatmap_tpu_torch.obs.events import read_events

        records = read_events(path)
        for rec in records:
            self.observe(rec)
        return len(records)

    # -- evaluation --------------------------------------------------------
    def _evaluate_one(self, spec: SLOSpec, now: float) -> dict:
        cutoff = now - spec.window_s
        if spec.kind == "staleness":
            with self._lock:
                last = self._last_fresh
            age = None if last is None else max(0.0, now - last)
            # No freshness signal yet = no data, not a breach.
            good = 1 if (age is None or age <= spec.max_age_s) else 0
            total = 0 if age is None else 1
            detail = {"age_s": None if age is None else round(age, 3),
                      "max_age_s": spec.max_age_s}
        else:
            with self._lock:
                rows = [r for r in self._window if r[0] >= cutoff]
            if spec.route is not None:
                rows = [r for r in rows if r[1] == spec.route]
            total = len(rows)
            if spec.kind == "latency":
                rows = [r for r in rows if r[3] is not None]
                total = len(rows)
                good = sum(1 for r in rows if r[3] <= spec.threshold_ms)
                detail = {"threshold_ms": spec.threshold_ms}
            else:  # error_rate
                good = sum(
                    1 for r in rows
                    if r[2] is not None and int(r[2]) < 500)
                detail = {}
        compliance = (good / total) if total else 1.0
        burn = (1.0 - compliance) / spec.budget
        status = {"name": spec.name, "kind": spec.kind,
                  "target": spec.target, "window_s": spec.window_s,
                  "total": total, "good": good,
                  "compliance": round(compliance, 6),
                  "budget": round(spec.budget, 6),
                  "burn_rate": round(burn, 3),
                  "breaching": burn > 1.0}
        status.update(detail)
        return status

    def evaluate(self, now: float | None = None) -> list:
        """Status dict per objective; emits slo_breach on rising edges."""
        if now is None:
            now = time.time()
        statuses = [self._evaluate_one(spec, now) for spec in self.specs]
        edges = []
        with self._lock:
            for st in statuses:
                name = st["name"]
                if st["breaching"] and name not in self._breaching:
                    self._breaching.add(name)
                    edges.append(st)
                elif not st["breaching"] and name in self._breaching:
                    self._breaching.discard(name)
        if edges:
            from heatmap_tpu_torch.obs import events

            for st in edges:
                events.emit("slo_breach", slo=st["name"], kind=st["kind"],
                            burn_rate=st["burn_rate"],
                            compliance=st["compliance"],
                            target=st["target"], window_s=st["window_s"])
        return statuses

    def status(self, now: float | None = None) -> dict:
        """Folded view for /healthz and the run report."""
        statuses = self.evaluate(now=now)
        breaching = [st["name"] for st in statuses if st["breaching"]]
        return {"objectives": statuses, "breaching": breaching,
                "ok": not breaching}

    def burn_snapshot(self, now: float | None = None) -> dict:
        """Machine-readable burn fractions: ``{objective_name: burn}``.

        A pure read over the same evaluation as ``status`` but with no
        breach-edge bookkeeping and no event emission — safe to call
        from a controller poll loop or a health probe at any frequency.
        Burn 1.0 spends the error budget exactly at the window's pace;
        >1.0 is a breach.
        """
        if now is None:
            now = time.time()
        return {spec.name: self._evaluate_one(spec, now)["burn_rate"]
                for spec in self.specs}

    def reset(self):
        with self._lock:
            self._window.clear()
            self._last_fresh = None
            self._breaching.clear()


# -- process-wide default engine ------------------------------------------

_engine: SLOEngine | None = None


def set_engine(engine: SLOEngine | None):
    """Install (or clear) the default engine and wire it as the event
    observer so live emission feeds the evaluation window."""
    global _engine
    _engine = engine
    from heatmap_tpu_torch.obs import events

    events._observer = engine.observe if engine is not None else None


def get_engine() -> SLOEngine | None:
    return _engine


def install_specs(specs) -> SLOEngine | None:
    """Parse spec strings and install the resulting engine; a falsy
    spec list clears the engine. Returns the engine (or None)."""
    if not specs:
        set_engine(None)
        return None
    engine = SLOEngine([parse_slo_spec(s) for s in specs])
    set_engine(engine)
    return engine


def slo_status(now: float | None = None) -> dict | None:
    """Default engine's folded status, or None when no engine is
    installed (what /healthz and build_run_report call)."""
    engine = _engine
    if engine is None:
        return None
    return engine.status(now=now)


def burn_values(now: float | None = None) -> dict:
    """Default engine's numeric burn fractions (``{name: burn}``), or
    ``{}`` when no engine is installed — the brownout controller's
    default burn source and the /healthz ``slo_burn`` block."""
    engine = _engine
    if engine is None:
        return {}
    return engine.burn_snapshot(now=now)
