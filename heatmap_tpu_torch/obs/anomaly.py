"""Streaming anomaly detection over sampled telemetry series.

The port's copy of heatmap_tpu/obs/anomaly.py (stdlib only): the same
behaviour for the same calls.

Per-watched-series detectors combine an **EWMA** center with a
**MAD**-scaled z-score: the center tracks the series' recent level,
the scale is the median absolute deviation of a bounded residual
window (robust to the very outliers being hunted), and
``z = |value - ewma| / (1.4826 * MAD)``. Detectors are edge-triggered
like every other obs alarm (``slo_breach``, ``degraded_enter``): one
``anomaly_detected`` event per breach episode on the rising edge,
cleared with hysteresis at half the threshold, never one event per
evaluation. Everything is a pure function of the sample stream and
the injectable clock — a fake-clock scripted spike fires exactly one
edge, deterministically (tests/test_timeseries.py).

Watch specs ride the CLI as ``--watch 'NAME:k=v,...'`` (repeatable),
the same grammar shape as ``--slo`` (obs/slo.py):

    --watch 'ingest_lag_seconds:z=6'
    --watch 'tile_cache_stale_serves_total:z=4,alpha=0.2,min_count=16'

``NAME`` matches the flattened series name (histograms flatten to
``<name>_sum``/``<name>_count`` — watching the bare histogram name
watches its per-tick mean). Signal extraction by metric kind: gauges
alarm on the sampled value, counters on the per-tick rate, histograms
on the per-tick mean of new observations — so a watch on
``ingest_lag_seconds`` reads "mean ingest lag this tick", not a
monotonic sum.

The engine plugs into the sampler (``TelemetrySampler(engine=...)``)
and each emitted edge reaches the :class:`~heatmap_tpu_torch.obs.incident.
IncidentManager` as the ``anomaly`` trigger kind, so a latency spike
or ingest-lag runaway flushes a bundle with the surrounding history
embedded (docs/observability.md).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from heatmap_tpu_torch.obs import timeseries

#: Residual window per detector — bounds both memory and how long an
#: old regime biases the MAD.
WINDOW = 32

_EPS = 1e-9

_PARAM_TYPES = {
    "z": float,          # z-score threshold (rising edge)
    "alpha": float,      # EWMA decay toward the newest sample
    "min_count": int,    # warm-up samples before the detector can fire
    "clear_ratio": float,  # hysteresis: clears below z * clear_ratio
}


@dataclass(frozen=True)
class WatchSpec:
    name: str
    z: float = 6.0
    alpha: float = 0.3
    min_count: int = 10
    clear_ratio: float = 0.5


def parse_watch_spec(spec: str) -> WatchSpec:
    """``NAME:k=v,...`` -> :class:`WatchSpec`; raises ``ValueError``
    with the offending token on any malformed input (the CLI converts
    that to a clean SystemExit, same as ``--slo``)."""
    name, _, rest = spec.partition(":")
    name = name.strip()
    if not name:
        raise ValueError(f"watch spec {spec!r}: empty series name")
    params = {}
    for token in filter(None, (t.strip() for t in rest.split(","))):
        key, eq, value = token.partition("=")
        if not eq:
            raise ValueError(f"watch spec {spec!r}: expected k=v, "
                             f"got {token!r}")
        caster = _PARAM_TYPES.get(key)
        if caster is None:
            raise ValueError(f"watch spec {spec!r}: unknown param "
                             f"{key!r} (known: "
                             f"{', '.join(sorted(_PARAM_TYPES))})")
        try:
            params[key] = caster(value)
        except ValueError as e:
            raise ValueError(f"watch spec {spec!r}: bad {key}={value!r}"
                             ) from e
    spec_obj = WatchSpec(name=name, **params)
    if spec_obj.z <= 0 or not (0.0 < spec_obj.alpha <= 1.0):
        raise ValueError(f"watch spec {spec!r}: need z > 0 and "
                         f"0 < alpha <= 1")
    return spec_obj


class SeriesDetector:
    """EWMA center + MAD scale + edge-triggered breach state for one
    series under one watch."""

    def __init__(self, spec: WatchSpec):
        self.spec = spec
        self.ewma: float | None = None
        self.window: deque = deque(maxlen=WINDOW)
        self.count = 0
        self.breaching = False
        self.last_z = 0.0

    def observe(self, value: float) -> bool:
        """Feed one signal value; True exactly on a rising edge."""
        spec = self.spec
        center = self.ewma if self.ewma is not None else value
        residual = value - center
        z = 0.0
        if self.count >= spec.min_count:
            mad = _median([abs(v - _median(list(self.window)))
                           for v in self.window]) if self.window else 0.0
            z = abs(residual) / (1.4826 * mad + _EPS)
        self.last_z = z
        # Update state *after* scoring so the spike itself cannot
        # absorb into the baseline before it is judged.
        self.window.append(value)
        self.ewma = center + spec.alpha * residual
        self.count += 1
        if self.breaching:
            if z < spec.z * spec.clear_ratio:
                self.breaching = False
            return False
        if z >= spec.z and self.count > spec.min_count:
            self.breaching = True
            return True
        return False


def _median(values) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return float(ordered[mid])
    return (ordered[mid - 1] + ordered[mid]) / 2.0


@dataclass
class Anomaly:
    ts: float
    series: str
    watch: str
    value: float
    z: float
    threshold: float

    def to_dict(self) -> dict:
        return {"ts": self.ts, "series": self.series, "watch": self.watch,
                "value": self.value, "z": round(self.z, 3),
                "threshold": self.threshold}


class AnomalyEngine:
    """Watch-list evaluation over sampler ticks.

    ``observe_tick(flat, ts)`` takes the same flattened snapshot the
    sampler appended (``timeseries.flatten_snapshot``), extracts each
    watched series' signal, updates its detector, and emits one
    ``anomaly_detected`` event per rising edge. Recent anomalies are
    ringed for ``/healthz`` and the dashboard.
    """

    def __init__(self, specs, *, clock=time.time, max_recent: int = 64):
        self.specs = list(specs)
        self.clock = clock
        self._detectors: dict[str, SeriesDetector] = {}
        self._prev: dict[str, tuple] = {}
        self._recent: deque = deque(maxlen=max_recent)
        self.edges = 0

    def _signal(self, key: str, kind: str, value: float,
                ts: float) -> float | None:
        """Kind-aware signal: gauge -> value, counter -> per-tick rate,
        histogram mean via the ``_sum``/``_count`` pair (handled by
        spec matching, see :meth:`observe_tick`)."""
        if kind != "counter":
            return value
        prev = self._prev.get(key)
        self._prev[key] = (ts, value)
        if prev is None:
            return None
        dt = ts - prev[0]
        if dt <= 0:
            return None
        return max(0.0, value - prev[1]) / dt

    def observe_tick(self, flat: dict, ts: float | None = None):
        when = self.clock() if ts is None else float(ts)
        for spec in self.specs:
            for key, signal in self._match(spec, flat, when):
                detector = self._detectors.get(key)
                if detector is None:
                    detector = SeriesDetector(spec)
                    self._detectors[key] = detector
                if detector.observe(signal):
                    self._emit(when, key, spec, signal, detector.last_z)

    def _match(self, spec: WatchSpec, flat: dict, when: float):
        """Yield ``(series_key, signal)`` for every flattened series
        the spec names. A watch on a bare histogram name pairs its
        ``_sum``/``_count`` series into a per-tick mean."""
        sum_name, count_name = spec.name + "_sum", spec.name + "_count"
        sums, counts = {}, {}
        for key in sorted(flat):
            name, _labels = timeseries.parse_series_key(key)
            kind, value = flat[key]
            if name == spec.name:
                signal = self._signal(key, kind, value, when)
                if signal is not None:
                    yield key, signal
            elif name == sum_name:
                sums[key[len(sum_name):]] = value
            elif name == count_name:
                counts[key[len(count_name):]] = value
        for labels_part, count in sorted(counts.items()):
            total = sums.get(labels_part)
            if total is None:
                continue
            pair_key = spec.name + labels_part
            prev = self._prev.get(pair_key)
            self._prev[pair_key] = (count, total)
            if prev is None:
                continue
            d_count = count - prev[0]
            if d_count <= 0:
                continue
            yield pair_key, (total - prev[1]) / d_count

    def _emit(self, when, key, spec, value, z):
        from heatmap_tpu_torch.obs import events

        anomaly = Anomaly(ts=when, series=key, watch=spec.name,
                          value=float(value), z=float(z),
                          threshold=spec.z)
        self._recent.append(anomaly)
        self.edges += 1
        from heatmap_tpu_torch import obs

        if obs.metrics_enabled():
            obs.ANOMALIES_TOTAL.inc(watch=spec.name)
        events.emit("anomaly_detected", series=key, z=round(float(z), 3),
                    threshold=spec.z, watch=spec.name,
                    value=float(value))

    def recent(self, n: int = 16) -> list:
        return [a.to_dict() for a in list(self._recent)[-n:]]

    def status(self) -> dict:
        return {
            "watches": [{"name": s.name, "z": s.z, "alpha": s.alpha,
                         "min_count": s.min_count} for s in self.specs],
            "series_tracked": len(self._detectors),
            "breaching": sorted(k for k, d in self._detectors.items()
                                if d.breaching),
            "edges": self.edges,
            "recent": self.recent(),
        }


# -- module state -----------------------------------------------------------

_engine: AnomalyEngine | None = None


def set_engine(engine: AnomalyEngine | None):
    global _engine
    _engine = engine


def get_engine() -> AnomalyEngine | None:
    return _engine
