"""The tick pump of continuous ingest: source -> bounded queue -> ticks.

The port's copy of ``TickContext`` and ``run_ticks`` from
heatmap_tpu/ingest/loop.py (stdlib only). A producer thread pulls items
(micro-batches) into a bounded queue, so a full queue blocks the
producer (back-pressure: an unbounded source never outruns the ticks),
and the caller's thread runs one tick per item. Without a depth the
ticks run synchronously in the calling thread, the cadence of
``streaming.run_stream``.

The rest of the JAX module (journaled ``run_ingest`` with its obs,
tracing and fault hooks) is not ported here.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue as queue_mod
import threading
import time

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

    ``name`` labels the producer thread (``{name}-producer``).

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
