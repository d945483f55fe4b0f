"""Continuous ingest: source -> bounded queue -> journaled apply.

The port's copy of heatmap_tpu/ingest/loop.py. A producer thread pulls
micro-batches from any ``io/sources.py`` source into a bounded queue (a
full queue blocks the producer: back-pressure, so an unbounded source
never outruns the apply path), and the consumer runs one **tick** per
micro-batch:

1. journal + apply through the ordinary cascade on the card
   (``delta.apply_batch``: exactly-once by content hash, so a retried or
   replayed tick is an idempotent no-op);
2. compact the delta stack when the size/age policy says so.

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
- faults: ticks run under the ``ingest.tick`` site with its retry
  policy, and the feeder's transfers under ``feeder.put``. Both are
  idempotent end to end; a crash mid-tick heals byte-identical through
  ``delta/recover.py`` on the next apply's startup sweep.

The feeder (``pipeline/feeder.py``, ``feed_depth``) moves micro-batch
k+1's numeric columns to the card while tick k runs
(``feeder.CudaColumns``); the tick hashes and journals the host columns
and cascades the fed tensors.

Publishing to a live tile server (the provisional synopsis overlay,
``refresh_serving`` and the window roll of the JAX loop) needs
``serve/`` and ``temporal/`` (ROADMAP Queue 1 items 6 and 5):
``run_ingest`` refuses a ``store`` or ``cache`` until then.

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
    #: (needs a serve store, which run_ingest refuses until serve/ is
    #: ported; kept for the JAX package's field set).
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
    unless the caller names the CPU).

    ``config=None`` defaults to ``BatchJobConfig(pad_bucketing="pow2")``.
    Safe to restart after any crash: the journal's content hashes make
    every tick exactly-once, and the recovery sweep inside
    ``apply_batch`` quarantines torn state first.

    ``store``/``cache`` (a live tile server to publish each tick to)
    raise NotImplementedError: serving is ROADMAP Queue 1 item 6.
    """
    from heatmap_tpu_torch import delta as delta_mod
    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.ingest import metrics as ingest_metrics
    from heatmap_tpu_torch.pipeline import feeder as feeder_mod
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    if store is not None or cache is not None:
        raise NotImplementedError(
            "run_ingest(store=, cache=) publishes to a live tile server "
            "(provisional synopsis overlay, refresh_serving, window "
            "roll), which needs serve/: not ported yet (ROADMAP Queue 1 "
            "item 6)")
    ing = ingest or IngestConfig()
    if config is None:
        config = BatchJobConfig(pad_bucketing="pow2")
    device = resolve_device(device)
    stats = IngestStats()
    t_loop = time.monotonic()
    # Monotonic clock of the oldest live delta, for the age trigger.
    oldest_live: list = []
    metrics_on = obs.metrics_enabled()

    def _tick(item, ctx: TickContext):
        t0 = time.monotonic()
        got = feeder_mod.ready(item)
        if isinstance(got, feeder_mod.FedColumns):
            cols, fed = got.cols, got.device
        else:
            cols, fed = got, None
        with tracing.span("ingest.tick", tick=ctx.index):
            def _apply():
                return delta_mod.apply_batch(
                    root, delta_mod.ColumnsSource(cols), config,
                    sign=ing.sign, device=device, device_columns=fed)

            result = faults.retry_call(
                _apply, site="ingest.tick", key=ctx.index)
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
                 keys_invalidated=0, compacted=compacted)

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
