"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of heatmap_tpu/obs/metrics.py (stdlib only): the same
series names, labels and Prometheus text for the same calls.

Same zero-cost discipline as ``utils.trace.stage_span``: every mutation
checks the registry's ``enabled`` flag first and returns immediately when
no sink is configured, so instrumented hot paths pay one attribute read
and one boolean test when telemetry is off.

Metrics carry a fixed set of label names declared at creation time
(``counter("points_binned_total", labelnames=("backend",))``); each
distinct label-value tuple becomes its own time series, mirroring the
Prometheus data model. ``render_prometheus`` writes the text exposition
format (``# HELP`` / ``# TYPE`` plus ``name{label="v"} value`` lines,
histogram ``_bucket``/``_sum``/``_count`` with a ``+Inf`` bucket) so a
``--metrics-dir`` dump can be scraped or diffed directly.

The module-level default registry is the process-wide instance every
instrumentation site uses (``get_registry()`` — the ``get_tracer()``
pattern); tests reset it between cases.
"""

from __future__ import annotations

import bisect
import os
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Exemplar identity hook: installed by obs.tracing.enable_tracing (the
# events._trace_ids pattern); returns the ambient (trace_id, span_id)
# so each histogram bucket remembers the last trace that landed in it.
_exemplar_ids = None

# Wall-clock seconds; spans range from sub-ms host hops to multi-minute
# ingest scans, so the grid is log-ish from 1ms to ~2min.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0, 120.0)


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value) if isinstance(value, float) else str(value)


class _Metric:
    """Base: label validation + the shared registry lock."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: tuple):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._values: dict = {}

    def _key(self, labels: dict) -> tuple:
        if len(labels) != len(self.labelnames) or any(
                k not in labels for k in self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def clear(self):
        with self._registry._lock:
            self._values.clear()

    def samples(self) -> dict:
        """Snapshot ``{label-tuple: value}`` (value shape is kind-specific)."""
        with self._registry._lock:
            return dict(self._values)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1, **labels):
        reg = self._registry
        if not reg.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        key = self._key(labels)
        with reg._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._registry._lock:
            return self._values.get(self._key(labels), 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        reg = self._registry
        if not reg.enabled:
            return
        key = self._key(labels)
        with reg._lock:
            self._values[key] = value

    def inc(self, amount: float = 1, **labels):
        reg = self._registry
        if not reg.enabled:
            return
        key = self._key(labels)
        with reg._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._registry._lock:
            return self._values.get(self._key(labels), 0)


class Histogram(_Metric):
    """Fixed-bucket histogram; per-series state is ``[counts, sum, n]``
    where ``counts[i]`` is the number of observations <= buckets[i]
    (non-cumulative per bucket; cumulated at render time)."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(b != b or b == float("inf") for b in bs):
            raise ValueError("histogram buckets must be finite and non-empty")
        self.buckets = bs
        # (series-key, bucket-idx) -> (trace_id, span_id, value): the
        # last trace that landed in each bucket (OpenMetrics exemplar).
        # Kept out of the per-series state list so samples() consumers
        # still unpack [counts, sum, n].
        self._exemplars: dict = {}

    def observe(self, value: float, **labels):
        reg = self._registry
        if not reg.enabled:
            return
        key = self._key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        ids_fn = _exemplar_ids
        ids = ids_fn() if ids_fn is not None else None
        with reg._lock:
            state = self._values.get(key)
            if state is None:
                state = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._values[key] = state
            state[0][idx] += 1
            state[1] += value
            state[2] += 1
            if ids is not None:
                self._exemplars[(key, idx)] = (ids[0], ids[1], value)

    def samples(self) -> dict:
        with self._registry._lock:
            return {k: [list(v[0]), v[1], v[2]]
                    for k, v in self._values.items()}

    def exemplars(self) -> dict:
        """Snapshot ``{(series-key, bucket-idx): (trace_id, span_id,
        value)}`` — the last observation that landed in each bucket
        while tracing supplied an ambient identity."""
        with self._registry._lock:
            return dict(self._exemplars)

    def clear(self):
        with self._registry._lock:
            self._values.clear()
            self._exemplars.clear()


class MetricsRegistry:
    """Thread-safe, process-wide home for all metrics.

    Creation is get-or-create: asking for an existing name returns the
    same object; asking with a different kind or label set raises, so
    two call sites cannot silently fork a series.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict = {}
        self.enabled = False

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or (
                        existing.labelnames != labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}")
                return existing
            metric = cls(self, name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def reset(self):
        """Clear all recorded values. Metric *definitions* (and the
        objects instrumentation sites hold) stay registered, so cached
        handles in obs/__init__ remain valid across test resets."""
        with self._lock:
            for m in self._metrics.values():
                m._values.clear()
                exemplars = getattr(m, "_exemplars", None)
                if exemplars is not None:
                    exemplars.clear()

    def snapshot(self) -> dict:
        """JSON-ready dump: ``{name: {type, help, labelnames, samples}}``
        where samples is a list of ``{labels, value}`` (counter/gauge)
        or ``{labels, buckets, sum, count}`` (histogram)."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            entries = []
            exemplars = (m.exemplars() if m.kind == "histogram" else {})
            for key, val in sorted(m.samples().items()):
                labels = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    counts, total, n = val
                    cum, acc = {}, 0
                    for b, c in zip(m.buckets + (float("inf"),), counts):
                        acc += c
                        cum[_fmt(b)] = acc
                    entry = {"labels": labels, "buckets": cum,
                             "sum": total, "count": n}
                    ex = {}
                    bounds = m.buckets + (float("inf"),)
                    for idx, bound in enumerate(bounds):
                        hit = exemplars.get((key, idx))
                        if hit is not None:
                            ex[_fmt(bound)] = {"trace_id": hit[0],
                                               "span_id": hit[1],
                                               "value": hit[2]}
                    if ex:
                        entry["exemplars"] = ex
                    entries.append(entry)
                else:
                    entries.append({"labels": labels, "value": val})
            out[m.name] = {"type": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames),
                           "samples": entries}
        return out

    def render_prometheus(self) -> str:
        """Text exposition format (version 0.0.4)."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            samples = m.samples()
            if not samples:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in sorted(samples.items()):
                base = ",".join(
                    f'{ln}="{_escape_label(lv)}"'
                    for ln, lv in zip(m.labelnames, key))
                if m.kind == "histogram":
                    counts, total, n = val
                    exemplars = m.exemplars()
                    acc = 0
                    for idx, (b, c) in enumerate(
                            zip(m.buckets + (float("inf"),), counts)):
                        acc += c
                        le = (base + "," if base else "") + f'le="{_fmt(b)}"'
                        line = f"{m.name}_bucket{{{le}}} {acc}"
                        hit = exemplars.get((key, idx))
                        if hit is not None:
                            # OpenMetrics-style exemplar: the last
                            # trace that landed in this bucket.
                            line += (f' # {{trace_id="{hit[0]}",'
                                     f'span_id="{hit[1]}"}} '
                                     f"{_fmt(hit[2])}")
                        lines.append(line)
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{m.name}_sum{suffix} {_fmt(total)}")
                    lines.append(f"{m.name}_count{suffix} {n}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{m.name}{suffix} {_fmt(val)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.render_prometheus())
        os.replace(tmp, path)


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry all instrumentation records into."""
    return _default


def enable_metrics(on: bool = True):
    _default.enabled = bool(on)


def metrics_enabled() -> bool:
    return _default.enabled
