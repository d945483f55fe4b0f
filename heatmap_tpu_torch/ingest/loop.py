"""Continuous ingest: source -> bounded queue -> journaled apply.

The port's copy of heatmap_tpu/ingest/loop.py. A producer thread pulls
micro-batches from any ``io/sources.py`` source into a bounded queue (a
full queue blocks the producer: back-pressure, so an unbounded source
never outruns the apply path), and the consumer runs one **tick** per
micro-batch:

1. journal + apply through the ordinary cascade on the card
   (``delta.apply_batch``: exactly-once by content hash, so a retried or
   replayed tick is an idempotent no-op);
2. publish to a live serve store via ``delta.refresh_serving``
   (targeted invalidation, no generation bump);
3. compact the delta stack when the size/age policy says so.

``run_ingest`` defaults the job config to bucketed padding
(``pipeline/bucketing.py``, ``pad_bucketing="pow2"``), as the JAX
package does for its compile cache; the bytes are the same either way.

The loop rides the existing planes:

- obs: event-time watermark and ingest-to-servable lag on the registry
  (``ingest/metrics.py``), one ``ingest_tick`` event per tick, the
  ``staleness`` SLO kind over tick recency (obs/slo.py), the flight
  recorder's tail promotion per tick and the time-series spill at the
  end;
- tracing: every tick is an ``ingest.tick`` span;
- faults: ticks and publishes run under the ``ingest.tick`` /
  ``ingest.publish`` sites with their retry policies, and the feeder's
  transfers under ``feeder.put``. All are idempotent end to end; a
  crash mid-tick heals byte-identical through ``delta/recover.py`` on
  the next apply's startup sweep.

The feeder (``pipeline/feeder.py``, ``feed_depth``) moves micro-batch
k+1's numeric columns to the card while tick k runs
(``feeder.CudaColumns``); the tick hashes and journals the host columns
and cascades the fed tensors.

**Early serving** (docs/synopsis.md): before the exact apply, a tick
overlays the micro-batch's coarse cell counts onto the store's decoded
wavelet-synopsis views (``TileStore.publish_provisional``) under the
``ingest.synopsis`` fault site — a numpy projection on the host, no
cascade. ``?synopsis=1`` tiles reflect the batch immediately, marked
``stale=1``, until the exact apply's ``refresh_serving`` supersedes
them. The publish is best-effort: a terminal failure is swallowed, and
a duplicate tick's overlay is discarded by an immediate
``refresh_layers``. The card's work stays on this loop's thread; the
server's request threads read only the store's numpy levels.

Timestamps: event time comes from the batches' ``timestamp`` column
(the watermark); loop durations use ``time.monotonic()``. Wall-clock
sleeps, prints, and perf_counter are banned here (the obs grep guards);
blocking happens only inside queue waits.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue as queue_mod
import threading
import time

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.obs import recorder as recorder_mod
from heatmap_tpu_torch.obs import timeseries, tracing

_DONE = object()  # producer -> consumer end-of-stream sentinel
_POLL_S = 0.05    # producer put/abort poll interval (bounded wait, not a sleep)


@dataclasses.dataclass(frozen=True)
class TickContext:
    """Per-tick metadata ``run_ticks`` hands the tick callback."""

    index: int          #: 0-based tick number
    enqueued_at: float  #: time.monotonic() when the producer queued it
    queue_depth: int    #: items still waiting behind this one at dequeue


def run_ticks(items, tick, *, queue_depth: int | None = None,
              name: str = "ingest") -> dict:
    """Drive ``tick(item, ctx)`` over an iterable, optionally through a
    bounded producer/consumer queue.

    ``name`` labels the producer thread (``{name}-producer``), so
    several loops in one process stay tellable apart.

    ``queue_depth=None`` runs synchronously in the calling thread. With a
    depth, a producer thread reads ``items`` into a
    ``queue.Queue(maxsize=depth)`` while ticks run here: at most
    ``depth`` items wait in memory and a slow consumer blocks the
    producer. Producer exceptions re-raise in the caller after in-flight
    ticks finish; a tick exception unblocks and stops the producer
    before propagating.

    Returns ``{"ticks": n, "max_queue_depth": m}`` where ``m`` is the
    largest resident backlog observed at any dequeue.
    """
    stats = {"ticks": 0, "max_queue_depth": 0}
    if queue_depth is None:
        for i, item in enumerate(items):
            tick(item, TickContext(i, time.monotonic(), 0))
            stats["ticks"] += 1
        return stats
    if queue_depth < 1:
        raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
    q: queue_mod.Queue = queue_mod.Queue(maxsize=queue_depth)
    abort = threading.Event()
    producer_error: list = []

    def _produce():
        try:
            payloads = ((item, time.monotonic()) for item in items)
            for payload in itertools.chain(payloads, (_DONE,)):
                while not abort.is_set():
                    try:
                        q.put(payload, timeout=_POLL_S)
                        break
                    except queue_mod.Full:
                        continue
                if abort.is_set():
                    return
        except BaseException as e:  # re-raised in the consumer
            producer_error.append(e)
            abort.set()

    producer = threading.Thread(
        target=_produce, name=f"{name}-producer", daemon=True)
    producer.start()
    try:
        index = 0
        while True:
            try:
                got = q.get(timeout=_POLL_S)
            except queue_mod.Empty:
                if abort.is_set():
                    break
                continue
            if got is _DONE:
                break
            item, enqueued_at = got
            backlog = q.qsize()
            stats["max_queue_depth"] = max(
                stats["max_queue_depth"], backlog + 1)
            tick(item, TickContext(index, enqueued_at, backlog))
            stats["ticks"] += 1
            index += 1
    finally:
        abort.set()
        producer.join(timeout=5.0)
    if producer_error:
        raise producer_error[0]
    return stats


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Loop parameters (the job/pyramid config stays a BatchJobConfig)."""

    #: Points per micro-batch (the tick granularity).
    micro_batch: int = 1 << 14
    #: Bounded-queue depth (back-pressure bound). None = synchronous:
    #: no producer thread, read-next-batch happens between ticks.
    queue_depth: int | None = 4
    #: +1 inserts, -1 retracts every batch (journal-signed).
    sign: int = 1
    #: Compact when this many live (unfolded) deltas accumulate.
    #: 0 disables size-triggered compaction.
    compact_every: int = 16
    #: Compact when the oldest live delta is older than this many
    #: seconds (monotonic, measured from its apply). 0 disables.
    compact_max_age_s: float = 0.0
    #: Journal entries kept behind the fold (delta.compact retention).
    retention: int = 2
    #: Stop after this many ticks (None = drain the source).
    max_ticks: int | None = None
    #: Publish a provisional synopsis overlay before each exact apply
    #: (no-op when the serve store carries no synopsis views).
    provisional_synopsis: bool = True
    #: Host->device feeder depth (pipeline/feeder.py): micro-batch k+1's
    #: numeric columns transfer to the card while tick k computes, with
    #: at most this many fed batches resident ahead of the apply loop.
    #: 0 disables the feeder (columns transfer inside each tick).
    #: Byte-identical either way.
    feed_depth: int = 1

    def __post_init__(self):
        if self.micro_batch < 1:
            raise ValueError(
                f"micro_batch must be >= 1, got {self.micro_batch}")
        if self.sign not in (1, -1):
            raise ValueError("sign must be +1 (insert) or -1 (retraction)")
        if self.compact_every < 0 or self.compact_max_age_s < 0:
            raise ValueError("compaction thresholds must be >= 0")
        if self.feed_depth < 0:
            raise ValueError(
                f"feed_depth must be >= 0, got {self.feed_depth}")


@dataclasses.dataclass
class IngestStats:
    """Outcome of one ``run_ingest`` drain."""

    ticks: int = 0
    points: int = 0
    duplicates: int = 0
    epochs: list = dataclasses.field(default_factory=list)
    watermark: float | None = None
    max_queue_depth: int = 0
    compactions: int = 0
    keys_invalidated: int = 0
    seconds: float = 0.0
    #: Feeder outcome (zeros / 100.0 with feed_depth=0): worker seconds
    #: spent in host->device transfer, consumer seconds blocked waiting
    #: for a fed batch, share of transfer time hidden behind compute,
    #: and the high-water mark of fed batches resident ahead.
    feed_s: float = 0.0
    feed_wait_s: float = 0.0
    feed_overlap_pct: float = 100.0
    feeder_depth_hwm: int = 0


def _provisional_rows(store, cols, config, sign: int) -> dict:
    """Coarse cell rows for the serve store's synopsis zooms, computed
    from one micro-batch: ``{(user, timespan): {zoom: (rows, cols,
    values)}}`` in the shape ``TileStore.publish_provisional`` takes.

    A host-side shadow of the cascade's grouping (route_user / 'all'
    aggregation / timespan labels) — exact for the counts it covers,
    best-effort by contract: zooms with no synopsis view, timespan types
    the batch cannot label, and the ``amplify_all`` compat recurrence
    (not reproducible per-batch) all fall out as empty, and the exact
    apply supersedes everything it publishes.
    """
    targets: dict[tuple, list] = {}
    for name in store.layer_names():
        layer = store.layer(name)
        syn = getattr(layer, "synopses", None)
        if syn:
            targets[(layer.user, layer.timespan)] = sorted(syn)
    if not targets or getattr(config, "amplify_all", False):
        return {}
    import numpy as np

    from heatmap_tpu_torch.pipeline import groups, timespan
    from heatmap_tpu_torch.tilemath.mercator import project_points_np

    lat = np.asarray(cols.get("latitude", ()), np.float64)
    n = len(lat)
    if n == 0:
        return {}
    lon = np.asarray(cols["longitude"], np.float64)
    user_ids = cols.get("user_id") or [""] * n
    routed = np.empty(n, object)  # None = excluded (x-prefix)
    for i, uid in enumerate(user_ids):
        routed[i] = groups.route_user(uid)
    if getattr(config, "weighted", False) and cols.get("value") is not None:
        weights = np.asarray(cols["value"], np.float64) * float(sign)
    else:
        weights = np.full(n, float(sign))
    vocab = timespan.TimespanVocab()
    label_cols = []
    stamps = cols.get("timestamp")
    for ts_type in getattr(config, "timespans", ("alltime",)):
        try:
            label_cols.append(vocab.label_ids(
                ts_type, stamps if stamps is not None else [None] * n))
        except (TypeError, ValueError):
            continue  # dated type without usable timestamps
        if getattr(config, "first_timespan_only", False):
            break
    if not label_cols:
        return {}
    umasks = {}
    for user, _ in targets:
        if user not in umasks:
            if user == groups.ALL_NAME:
                umasks[user] = np.array([r is not None for r in routed])
            else:
                umasks[user] = routed == user
    out: dict[tuple, dict] = {}
    zooms = sorted({z for zs in targets.values() for z in zs})
    for zoom in zooms:
        rr, cc, valid = project_points_np(lat, lon, zoom)
        for (user, ts_name), pair_zooms in targets.items():
            if zoom not in pair_zooms:
                continue
            tid = vocab.id_for(ts_name)
            tmask = np.zeros(n, bool)
            for ids in label_cols:
                tmask |= ids == tid
            sel = umasks[user] & tmask & np.asarray(valid, bool)
            if not sel.any():
                continue
            out.setdefault((user, ts_name), {})[zoom] = (
                np.asarray(rr, np.int64)[sel],
                np.asarray(cc, np.int64)[sel],
                weights[sel])
    return out


def _roll_windows(root: str, cache, edge_holder: list) -> int:
    """Targeted sliding-window invalidation on a bucket roll.

    A ``?window=`` tile's population changes for exactly two reasons:
    new points inside the window (refresh_serving already invalidates
    those keys, window variants included) and old buckets RETIRING off
    the window's trailing edge when the newest bucket edge advances.
    This handles the second: when the reference edge moves, invalidate
    precisely the retiring buckets' tile keys x the served window
    params — every other cached entry (all-time, as_of, untouched
    windows) survives. The retiring keys stay ``TileKeySet``s, tested
    against the cache's own keys (``TileCache.invalidate_matching`` with
    ``windows_only``), so the count is the JAX package's without
    enumerating a bucket's keys.

    Best-effort by design: a torn bucket here means those keys go
    un-invalidated until their TTL, never a failed tick."""
    try:
        from heatmap_tpu_torch.temporal import buckets as tb
        from heatmap_tpu_torch.temporal import fold as tfold
        cfg = tfold.temporal_config(root)
        if cfg is None:
            return 0
        ref = tfold.newest_edge(root, cfg)
    except Exception:
        return 0
    if ref is None:
        return 0
    prev = edge_holder[0] if edge_holder else None
    edge_holder[:] = [ref]
    if prev is None or ref <= prev:
        return 0
    params = cache.window_params() if cache is not None else ()
    n = 0
    retired = 0
    if params:
        from heatmap_tpu_torch.delta.compute import affected_tile_keys
        from heatmap_tpu_torch.io.sinks import LevelArraysSink
        windows = []
        for p in params:
            try:
                windows.append(tb.parse_window(p, cfg))
            except ValueError:
                continue
        dirs = tfold.retiring_dirs(root, prev, ref, windows)
        retired = len(dirs)
        keys = None
        for d in dirs:
            try:
                got = affected_tile_keys(LevelArraysSink.load(d))
            except Exception:
                continue
            keys = got if keys is None else keys | got
        if keys:
            n = cache.invalidate_matching(keys, params, windows_only=True)
    obs.emit("bucket_roll", root=root, prev_ref=prev, ref=ref,
             retired=retired, keys_invalidated=n,
             windows=list(params))
    return n


def _event_watermark(cols) -> float | None:
    """Max event-time timestamp of a column batch (None when absent)."""
    stamps = cols.get("timestamp")
    if stamps is None or not len(stamps):
        return None
    try:
        return max(float(t) for t in stamps if t is not None)
    except (TypeError, ValueError):
        return None


def run_ingest(root: str, source, config=None, *,
               ingest: IngestConfig | None = None,
               store=None, cache=None, device="cuda") -> IngestStats:
    """Drain ``source`` through the continuous-ingest loop into the
    delta store at ``root``, each tick's cascade on ``device`` (the card
    unless the caller names the CPU), publishing to ``store``/``cache``
    (a live ``serve.TileStore`` mounted on this root's ``delta:`` spec)
    when given.

    ``config=None`` defaults to ``BatchJobConfig(pad_bucketing="pow2")``.
    Safe to restart after any crash: the journal's content hashes make
    every tick exactly-once, and the recovery sweep inside
    ``apply_batch`` quarantines torn state first.
    """
    from heatmap_tpu_torch import delta as delta_mod
    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.ingest import metrics as ingest_metrics
    from heatmap_tpu_torch.pipeline import feeder as feeder_mod
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    ing = ingest or IngestConfig()
    if config is None:
        config = BatchJobConfig(pad_bucketing="pow2")
    device = resolve_device(device)
    stats = IngestStats()
    t_loop = time.monotonic()
    # Monotonic clock of the oldest live delta, for the age trigger.
    oldest_live: list = []
    # Last-seen newest bucket edge (temporal plane): a roll past it
    # retires window tiles via _roll_windows' targeted invalidation.
    bucket_edge: list = []
    metrics_on = obs.metrics_enabled()

    def _tick(item, ctx: TickContext):
        t0 = time.monotonic()
        got = feeder_mod.ready(item)
        if isinstance(got, feeder_mod.FedColumns):
            cols, fed = got.cols, got.device
        else:
            cols, fed = got, None
        with tracing.span("ingest.tick", tick=ctx.index):
            provisional = 0
            if store is not None and ing.provisional_synopsis:
                def _early():
                    rows_by = _provisional_rows(store, cols, config,
                                                ing.sign)
                    return store.publish_provisional(rows_by)

                # Best-effort early serving: a terminal failure here
                # must not cost the tick its exact apply.
                try:
                    provisional = faults.retry_call(
                        _early, site="ingest.synopsis", key=ctx.index)
                except Exception:
                    provisional = 0

            def _apply():
                return delta_mod.apply_batch(
                    root, delta_mod.ColumnsSource(cols), config,
                    sign=ing.sign, device=device, device_columns=fed)

            result = faults.retry_call(
                _apply, site="ingest.tick", key=ctx.index)
            invalidated = 0
            if store is not None and result.duplicate and provisional:
                # The overlay double-counted an already-applied batch;
                # rebuilding the index discards every provisional view.
                store.refresh_layers()
            if store is not None and not result.duplicate:
                invalidated = faults.retry_call(
                    delta_mod.refresh_serving, result, store, cache,
                    site="ingest.publish", key=ctx.index)
            if cache is not None and not result.duplicate:
                invalidated += _roll_windows(root, cache, bucket_edge)
            compacted = False
            if not result.duplicate:
                if not oldest_live:
                    oldest_live.append(t0)
                live = (ing.compact_every or ing.compact_max_age_s) and \
                    len(delta_mod.live_entries(root))
                due_size = ing.compact_every and live >= ing.compact_every
                due_age = (ing.compact_max_age_s and live and
                           time.monotonic() - oldest_live[0]
                           >= ing.compact_max_age_s)
                if due_size or due_age:
                    delta_mod.compact(root, retention=ing.retention)
                    oldest_live.clear()
                    compacted = True
                    stats.compactions += 1
                    if store is not None:
                        # Compaction is byte-neutral (base ⊕ deltas
                        # pinned identical), so re-point the overlay
                        # without dropping any cache entries.
                        store.refresh_layers()
        seconds = time.monotonic() - t0
        # Tail-based retention: a tick past the recorder's latency
        # threshold promotes its whole (possibly unsampled) tree out of
        # the flight recorder as if it had been head-sampled.
        recorder_mod.maybe_promote(ms=seconds * 1e3)
        lag = max(0.0, time.monotonic() - ctx.enqueued_at)
        wm = _event_watermark(cols)
        if wm is not None and (stats.watermark is None
                               or wm > stats.watermark):
            stats.watermark = wm  # monotonic under out-of-order batches
        stats.ticks += 1
        stats.points += result.points if not result.duplicate else 0
        stats.keys_invalidated += invalidated
        if result.duplicate:
            stats.duplicates += 1
        else:
            stats.epochs.append(result.epoch)
        if metrics_on:
            ingest_metrics.INGEST_TICKS.inc(
                status="duplicate" if result.duplicate else "applied")
            if not result.duplicate:
                ingest_metrics.INGEST_POINTS.inc(result.points)
            if stats.watermark is not None:
                ingest_metrics.INGEST_WATERMARK.set(stats.watermark)
            ingest_metrics.INGEST_QUEUE_DEPTH.set(ctx.queue_depth)
            ingest_metrics.INGEST_LAG_SECONDS.observe(lag)
            ingest_metrics.INGEST_TICK_SECONDS.observe(seconds)
        obs.emit("ingest_tick", tick=ctx.index, points=result.points,
                 seconds=round(seconds, 6), epoch=result.epoch,
                 duplicate=result.duplicate, watermark=stats.watermark,
                 lag_s=round(lag, 6), queue_depth=ctx.queue_depth,
                 keys_invalidated=invalidated, compacted=compacted)

    batches = source.batches(ing.micro_batch)
    if ing.max_ticks is not None:
        batches = itertools.islice(batches, ing.max_ticks)
    fstats = None
    if ing.feed_depth:
        # Double-buffered host->device feeder: batch k+1's numeric
        # columns transfer while tick k journals and applies.
        # Order-preserving, and the hash reads the host columns, so
        # journal epochs and content hashes equal the unfed drain's. On
        # the CPU the transfer is the identity (the caller's device).
        fstats = feeder_mod.FeederStats()
        transfer = (feeder_mod.CudaColumns(device)
                    if device.type == "cuda" else _identity)
        batches = feeder_mod.feed(batches, transfer, depth=ing.feed_depth,
                                  stats=fstats, thread_name="ingest-feeder")
    with tracing.span("ingest.loop"):
        try:
            pump = run_ticks(batches, _tick, queue_depth=ing.queue_depth)
        finally:
            # Crash-safe telemetry: persist the sampled history so far
            # (atomic publish, obs/timeseries.py) even when a tick
            # raised. No-op with the sampler off or without a spill dir.
            timeseries.flush_spill()
    stats.max_queue_depth = pump["max_queue_depth"]
    stats.seconds = time.monotonic() - t_loop
    if fstats is not None:
        stats.feed_s = fstats.feed_s
        stats.feed_wait_s = fstats.wait_s
        stats.feed_overlap_pct = fstats.overlap_pct
        stats.feeder_depth_hwm = fstats.depth_hwm
    return stats


def _identity(cols):
    return cols
