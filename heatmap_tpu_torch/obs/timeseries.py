"""In-process tiered time-series store: the registry's memory.

The port's copy of heatmap_tpu/obs/timeseries.py (stdlib only): the same
behaviour for the same calls.

Every other obs surface is instantaneous — ``/metrics`` is a scrape,
``snapshot()`` is a point in time, the flight recorder holds spans but
not values. This module gives the process *history* without deploying
an external Prometheus: a background sampler appends registry
snapshots into bounded ring **tiers** (raw ~10 s points rolling up
into 1 m and 10 m buckets on eviction), each bucket carrying
``min/max/sum/count/last`` per series so rates, trends, and "was this
tick normal?" questions are answerable in-process. The same
bounded-error-summary idea the synopsis tier applies spatially
(docs/synopsis.md) applied on the time axis: raw recent samples,
compressed older ones, range queries stamped with the resolution they
were actually answered at.

Design points, mirroring the rest of ``obs/``:

- **Zero-cost when off.** Nothing here is wired into any hot path:
  the sampler *pulls* from the registry on its own thread, so with no
  sampler installed (the default — ``--telemetry-sample-interval 0``)
  the process runs zero extra threads, allocates nothing, and served
  blobs are byte-identical (tests/test_timeseries.py pins both).
- **Deterministic downsample-on-eviction.** When a tier's ring is
  full, the oldest point folds into the next tier's bucket
  (``min=min, max=max, sum+=sum, count+=count, last=newest``) — a
  pure function of the sample stream, so rollups equal brute-force
  recomputation exactly and repeat runs produce identical tiers.
- **Byte-capped.** Rings bound points per series; ``max_bytes`` bounds
  the series population (new series past the cap are dropped and
  counted, never grown).
- **Crash-safe optional spill.** ``spill()`` publishes the store into
  ``<spill_dir>/snap-N`` via the same fsync'd tmp-dir + rename as
  every other artifact (``utils.checkpoint.publish_dir``), keeping one
  previous snapshot; ``load_spill()`` on construction restores the
  newest complete snapshot and quarantines torn ones (a ``.tmp-``
  orphan or an unreadable snap moves to ``quarantine/`` with a
  ``quarantine`` event), so history survives restarts and rides along
  in incident bundles.

The injectable clock (ctor ``clock=time.time``) makes every test
fake-clock deterministic, same as the SLO engine and the incident
manager.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

#: (step_seconds, ring_capacity) finest-first. Raw 10 s x 360 = 1 h,
#: 1 m x 360 = 6 h, 10 m x 432 = 3 days — the retention math in
#: docs/observability.md.
DEFAULT_TIERS = ((10.0, 360), (60.0, 360), (600.0, 432))

#: Conservative in-memory cost of one bucket (7 floats + list
#: overhead); the unit the ``max_bytes`` series cap is computed in.
POINT_BYTES = 120

# Bucket layout: [bucket_ts, min, max, sum, count, last, last_ts].
_TS, _MIN, _MAX, _SUM, _COUNT, _LAST, _LAST_TS = range(7)


def series_key(name: str, labels: dict) -> str:
    """Canonical string key for one (metric, labelset) series:
    ``name`` or ``name{k=v,...}`` with labels sorted."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_series_key(key: str) -> tuple:
    """Inverse of :func:`series_key` -> ``(name, labels_dict)``."""
    name, brace, rest = key.partition("{")
    if not brace:
        return key, {}
    labels = {}
    for pair in rest.rstrip("}").split(","):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        labels[k] = v
    return name, labels


def flatten_snapshot(snapshot: dict) -> dict:
    """Registry snapshot -> ``{series_key: (kind, value)}``.

    Counters and gauges map to their value; a histogram maps to two
    series, ``<name>_sum`` and ``<name>_count`` (buckets are dropped —
    the store keeps trends, not distributions; the live histogram is
    always one ``/metrics`` scrape away).
    """
    flat = {}
    for name, meta in snapshot.items():
        kind = meta.get("type")
        for sample in meta.get("samples", ()):
            labels = sample.get("labels") or {}
            if kind == "histogram":
                flat[series_key(name + "_sum", labels)] = (
                    "counter", float(sample.get("sum", 0.0)))
                flat[series_key(name + "_count", labels)] = (
                    "counter", float(sample.get("count", 0)))
            else:
                try:
                    value = float(sample.get("value", 0.0))
                except (TypeError, ValueError):
                    continue
                flat[series_key(name, labels)] = (kind, value)
    return flat


class TimeSeriesStore:
    """Tiered per-series rings with deterministic rollup-on-eviction."""

    def __init__(self, *, tiers=DEFAULT_TIERS, max_bytes: int = 4 << 20,
                 spill_dir: str | None = None, clock=time.time):
        if not tiers:
            raise ValueError("at least one tier is required")
        steps = [float(s) for s, _ in tiers]
        if steps != sorted(steps):
            raise ValueError("tiers must be ordered finest-first")
        self.tiers = tuple((float(step), int(cap)) for step, cap in tiers)
        self.max_bytes = int(max_bytes)
        self.spill_dir = spill_dir
        self.clock = clock
        worst_case = POINT_BYTES * sum(cap for _, cap in self.tiers)
        self.max_series = max(1, self.max_bytes // worst_case)
        self._lock = threading.Lock()
        # key -> {"kind": str, "tiers": [deque, ...]}
        self._series: dict[str, dict] = {}
        self.samples_total = 0
        self.dropped_series = 0
        self._spill_seq = 0
        if spill_dir:
            self.load_spill()

    # -- append path -------------------------------------------------------

    def append(self, snapshot: dict, ts: float | None = None):
        """Fold one registry snapshot (``MetricsRegistry.snapshot()``)
        into the rings; the sampler's per-tick entry point."""
        self.append_flat(flatten_snapshot(snapshot), ts)

    def append_flat(self, flat: dict, ts: float | None = None):
        when = self.clock() if ts is None else float(ts)
        with self._lock:
            for key in sorted(flat):
                kind, value = flat[key]
                self._observe_locked(key, kind, value, when)
            self.samples_total += 1

    def observe(self, key: str, value: float, ts: float | None = None,
                kind: str = "gauge"):
        """Append one sample of one series (tests, ad-hoc feeds)."""
        when = self.clock() if ts is None else float(ts)
        with self._lock:
            self._observe_locked(key, kind, float(value), when)

    def _observe_locked(self, key, kind, value, when):
        entry = self._series.get(key)
        if entry is None:
            if len(self._series) >= self.max_series:
                self.dropped_series += 1
                return
            entry = {"kind": kind,
                     "tiers": [deque() for _ in self.tiers]}
            self._series[key] = entry
        self._fold(entry["tiers"], 0,
                   [when, value, value, value, 1, value, when])

    def _fold(self, rings, level, point):
        """Merge ``point`` into tier ``level`` at its bucket boundary;
        evictions cascade into the next tier (dropped past the last)."""
        step, cap = self.tiers[level]
        bucket = point[_TS] - (point[_TS] % step)
        ring = rings[level]
        if ring and ring[-1][_TS] == bucket:
            self._merge(ring[-1], point)
            return
        ring.append([bucket, point[_MIN], point[_MAX], point[_SUM],
                     point[_COUNT], point[_LAST], point[_LAST_TS]])
        while len(ring) > cap:
            evicted = ring.popleft()
            if level + 1 < len(self.tiers):
                self._fold(rings, level + 1, evicted)

    @staticmethod
    def _merge(into, point):
        into[_MIN] = min(into[_MIN], point[_MIN])
        into[_MAX] = max(into[_MAX], point[_MAX])
        into[_SUM] += point[_SUM]
        into[_COUNT] += point[_COUNT]
        if point[_LAST_TS] >= into[_LAST_TS]:
            into[_LAST] = point[_LAST]
            into[_LAST_TS] = point[_LAST_TS]

    # -- query path --------------------------------------------------------

    def query(self, name: str, labels: dict | None = None,
              start: float | None = None, end: float | None = None,
              step: float | None = None) -> dict:
        """Range query -> aligned frames stamped with the resolution
        they were answered at.

        ``name`` matches the metric name exactly; ``labels`` (subset
        match) narrows the label sets. ``start``/``end`` default to the
        last hour; ``step`` asks for a coarser resolution (buckets are
        regrouped deterministically — the achieved step is always
        stamped, never assumed). Tier choice per series: the finest
        tier whose retention still covers ``start``, falling back to
        the coarsest.
        """
        end_ts = self.clock() if end is None else float(end)
        start_ts = end_ts - 3600.0 if start is None else float(start)
        want = labels or {}
        frames = []
        with self._lock:
            for key in sorted(self._series):
                k_name, k_labels = parse_series_key(key)
                if k_name != name:
                    continue
                if any(k_labels.get(lk) != lv for lk, lv in want.items()):
                    continue
                entry = self._series[key]
                frame = self._frame_locked(entry, start_ts, end_ts, step)
                if frame is not None:
                    frame["labels"] = k_labels
                    frame["key"] = key
                    frames.append(frame)
        return {"name": name, "from": start_ts, "to": end_ts,
                "requested_step": step, "frames": frames}

    def _frame_locked(self, entry, start_ts, end_ts, step):
        chosen, chosen_step = None, None
        for level, (tier_step, _cap) in enumerate(self.tiers):
            ring = entry["tiers"][level]
            if ring and ring[0][_TS] <= start_ts:
                chosen, chosen_step = level, tier_step
                break
        if chosen is None:  # nothing retains back to start: coarsest
            for level in range(len(self.tiers) - 1, -1, -1):
                if entry["tiers"][level]:
                    chosen, chosen_step = level, self.tiers[level][0]
                    break
        if chosen is None:
            return None
        points = [list(p) for p in entry["tiers"][chosen]
                  if start_ts <= p[_TS] + chosen_step and p[_TS] < end_ts]
        achieved = chosen_step
        if step is not None and float(step) > chosen_step:
            achieved = float(step)
            regrouped: dict = {}
            order = []
            for p in points:
                bucket = p[_TS] - (p[_TS] % achieved)
                have = regrouped.get(bucket)
                if have is None:
                    have = [bucket, p[_MIN], p[_MAX], p[_SUM],
                            p[_COUNT], p[_LAST], p[_LAST_TS]]
                    regrouped[bucket] = have
                    order.append(bucket)
                else:
                    self._merge(have, p)
            points = [regrouped[b] for b in order]
        return {"step": achieved, "tier": chosen,
                "points": [p[:_LAST + 1] for p in points]}

    # -- snapshots (incident bundles, dashboard, spill) --------------------

    def recent_window(self, seconds: float = 300.0,
                      max_series: int = 64) -> dict:
        """The raw-tier window of the last ``seconds`` per series —
        what an incident bundle embeds so a post-mortem can read what
        changed just before the trigger."""
        now = self.clock()
        cut = now - float(seconds)
        out, truncated = {}, 0
        with self._lock:
            for key in sorted(self._series):
                points = [p[:_LAST + 1] for p in self._series[key]["tiers"][0]
                          if p[_TS] >= cut]
                if not points:
                    continue
                if len(out) >= max_series:
                    truncated += 1
                    continue
                out[key] = {"step": self.tiers[0][0], "points": points}
        return {"from": cut, "to": now, "window_s": float(seconds),
                "truncated_series": truncated, "series": out}

    def series_names(self) -> list:
        with self._lock:
            return sorted(self._series)

    def stats(self) -> dict:
        with self._lock:
            points = sum(len(ring) for e in self._series.values()
                         for ring in e["tiers"])
            return {
                "series": len(self._series),
                "points": points,
                "samples_total": self.samples_total,
                "dropped_series": self.dropped_series,
                "max_series": self.max_series,
                "tiers": [{"step_s": step, "capacity": cap}
                          for step, cap in self.tiers],
                "approx_bytes": points * POINT_BYTES,
                "spill_dir": self.spill_dir,
            }

    # -- crash-safe spill --------------------------------------------------

    def _dump_locked(self) -> dict:
        return {
            "version": 1,
            "tiers": [[step, cap] for step, cap in self.tiers],
            "samples_total": self.samples_total,
            "series": {key: {"kind": e["kind"],
                             "tiers": [[list(p) for p in ring]
                                       for ring in e["tiers"]]}
                       for key, e in self._series.items()},
        }

    def spill(self) -> str | None:
        """Publish the store under ``spill_dir`` atomically (tmp dir +
        fsync + rename, the ``publish_dir`` contract) and prune all but
        the previous snapshot. No-op without a spill dir."""
        if not self.spill_dir:
            return None
        from heatmap_tpu_torch.utils.checkpoint import publish_dir

        with self._lock:
            doc = self._dump_locked()
        os.makedirs(self.spill_dir, exist_ok=True)
        existing = [int(d.split("-", 1)[1]) for d in os.listdir(self.spill_dir)
                    if d.startswith("snap-") and d.split("-", 1)[1].isdigit()]
        seq = max([self._spill_seq - 1] + existing) + 1
        self._spill_seq = seq + 1
        final = os.path.join(self.spill_dir, f"snap-{seq:06d}")
        tmp = os.path.join(self.spill_dir, f".tmp-snap-{seq:06d}")
        os.makedirs(tmp, exist_ok=True)
        payload = json.dumps(doc, sort_keys=True).encode()
        with open(os.path.join(tmp, "series.json"), "wb") as f:
            f.write(payload)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"version": 1, "seq": seq, "bytes": len(payload),
                       "series": len(doc["series"])}, f, sort_keys=True)
        publish_dir(tmp, final)
        for old in sorted(existing):
            if old < seq - 1:
                _rmtree(os.path.join(self.spill_dir, f"snap-{old:06d}"))
        return final

    def load_spill(self) -> str | None:
        """Restore the newest complete snapshot under ``spill_dir``;
        torn entries (``.tmp-`` orphans, unreadable/malformed snaps)
        are quarantined, never trusted."""
        if not self.spill_dir or not os.path.isdir(self.spill_dir):
            return None
        names = sorted(os.listdir(self.spill_dir))
        for name in names:
            if name.startswith(".tmp-"):
                self._quarantine(name, "orphan_tmp")
        snaps = sorted((n for n in os.listdir(self.spill_dir)
                        if n.startswith("snap-")), reverse=True)
        for name in snaps:
            path = os.path.join(self.spill_dir, name)
            doc = self._read_snap(path)
            if doc is None:
                self._quarantine(name, "torn_telemetry")
                continue
            with self._lock:
                self._series = {
                    key: {"kind": e.get("kind", "gauge"),
                          "tiers": [deque(list(p) for p in ring)
                                    for ring in e["tiers"]]}
                    for key, e in doc.get("series", {}).items()
                    if len(e.get("tiers", ())) == len(self.tiers)}
                self.samples_total = int(doc.get("samples_total", 0))
                self._spill_seq = int(name.split("-", 1)[1]) + 1
            return path
        return None

    def _read_snap(self, path: str):
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with open(os.path.join(path, "series.json"), "rb") as f:
                payload = f.read()
            if manifest.get("bytes") != len(payload):
                return None
            doc = json.loads(payload)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def _quarantine(self, name: str, reason: str):
        from heatmap_tpu_torch.obs import events

        src = os.path.join(self.spill_dir, name)
        qdir = os.path.join(self.spill_dir, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, name.lstrip("."))
        try:
            if os.path.exists(dst):
                _rmtree(dst)
            os.rename(src, dst)
        except OSError:
            return
        events.emit("quarantine", root=self.spill_dir, path=dst,
                    reason=reason, kind="telemetry")


def _rmtree(path: str):
    import shutil

    shutil.rmtree(path, ignore_errors=True)


class TelemetrySampler:
    """Background sampler: one registry snapshot into the store per
    ``interval_s``, feeding the anomaly engine on the same tick.

    The thread waits on a :class:`threading.Event` (never sleeps) so
    ``stop()`` returns promptly; ``sample_once()`` is the same tick
    the thread runs, callable directly under a fake clock for
    deterministic tests. A sampling failure is swallowed and counted —
    telemetry must never take the process down.
    """

    def __init__(self, store: TimeSeriesStore, interval_s: float, *,
                 registry=None, engine=None, clock=time.time,
                 spill_every_ticks: int = 6):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.store = store
        self.interval_s = float(interval_s)
        self.engine = engine
        self.clock = clock
        self.spill_every_ticks = int(spill_every_ticks)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        self.errors = 0

    def sample_once(self, ts: float | None = None):
        from heatmap_tpu_torch.obs import metrics

        registry = self._registry or metrics.get_registry()
        when = self.clock() if ts is None else float(ts)
        flat = flatten_snapshot(registry.snapshot())
        self.store.append_flat(flat, when)
        self.ticks += 1
        engine = self.engine
        if engine is not None:
            engine.observe_tick(flat, when)
        if (self.store.spill_dir and self.spill_every_ticks > 0
                and self.ticks % self.spill_every_ticks == 0):
            self.store.spill()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                self.errors += 1

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="telemetry-sampler",
                                        daemon=True)
        self._thread.start()

    def stop(self, spill: bool = True):
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None
        if spill and self.store.spill_dir:
            try:
                self.store.spill()
            except OSError:
                pass


# -- module state (the obs install/get house pattern) -----------------------

_store: TimeSeriesStore | None = None
_sampler: TelemetrySampler | None = None


def install(store: TimeSeriesStore | None):
    """Install (or clear, with None) the process-wide store read by
    ``/series``, ``/dashboard``, and incident-bundle embedding."""
    global _store
    _store = store


def get_store() -> TimeSeriesStore | None:
    return _store


def get_sampler() -> TelemetrySampler | None:
    return _sampler


def arm(interval_s: float, *, engine=None, spill_dir: str | None = None,
        tiers=DEFAULT_TIERS, max_bytes: int = 4 << 20,
        clock=time.time) -> TelemetrySampler:
    """Construct + install a store and start its sampler thread — the
    CLI's one-call arming (``--telemetry-sample-interval``)."""
    global _sampler
    store = TimeSeriesStore(tiers=tiers, max_bytes=max_bytes,
                            spill_dir=spill_dir, clock=clock)
    install(store)
    sampler = TelemetrySampler(store, interval_s, engine=engine,
                               clock=clock)
    _sampler = sampler
    sampler.start()
    return sampler


def flush_spill():
    """Best-effort spill of the installed store (shutdown paths; no-op
    when nothing is installed or no spill dir is configured)."""
    store = _store
    if store is not None and store.spill_dir:
        try:
            store.spill()
        except OSError:
            pass


def shutdown():
    """Stop the sampler thread (spilling once) and clear the installed
    store — the teardown conftest runs between tests."""
    global _sampler, _store
    sampler = _sampler
    _sampler = None
    if sampler is not None:
        sampler.stop()
    _store = None
