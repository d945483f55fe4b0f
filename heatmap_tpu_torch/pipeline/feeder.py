"""Double-buffered host->device feeder.

Port of heatmap_tpu/pipeline/feeder.py. A worker thread builds item k+1
and transfers it to the device while the consumer computes on item k,
through a bounded FIFO queue, so at most ``depth`` fed items wait ahead
of the consumer. The chunked batch job (pipeline/batch.py) feeds each
chunk's ``latitude``, ``longitude`` and ``value`` columns this way.

Only the transfer differs from the JAX package's ``device_put``
(:class:`CudaTransfer` for the chunked job's tuples, :class:`CudaColumns`
for the ingest loop's column dicts, the counterpart of
``device_put_columns``): on a CUDA device the worker copies the numeric
columns into pinned host memory and issues ``non_blocking`` copies on a
side stream of its own, then records an event there; the consumer makes
its stream wait on that event before it reads the tensors
(:func:`ready`). On the CPU the transfer is the identity: that is the
caller's choice of device, not a fallback.

Byte identity: the feeder moves buffers, never values. Dtypes never
change (float64 stays float64), and fed order is source order (one
worker, a FIFO queue), so vocab ids and merge results equal the unfed
path's.

Fault plane: every transfer runs under the ``feeder.put`` site via
``faults.retry_call``; a transient (or injected) failure re-feeds the
same item, which is idempotent (a fresh copy; nothing downstream has
seen it). A terminal failure propagates to the consumer.

:class:`FeederStats`: ``feed_s`` (worker seconds in the transfer),
``wait_s`` (consumer seconds blocked on the queue), ``overlap_pct`` (the
share of transfer time hidden behind the consumer's work) and
``depth_hwm`` (most items resident ahead of the consumer).
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from heatmap_tpu_torch import faults, obs

_DONE = object()   # worker -> consumer end-of-stream sentinel
_POLL_S = 0.05     # bounded put/get poll interval (not a sleep loop)

#: Default bound on fed items resident ahead of the consumer: 1 is
#: classic double buffering.
DEFAULT_DEPTH = 1


@dataclasses.dataclass
class FeederStats:
    """Outcome of one feeder drain (shared with the consumer live)."""

    batches: int = 0     #: items fed through
    feed_s: float = 0.0  #: worker seconds spent in transfer (sum)
    wait_s: float = 0.0  #: consumer seconds blocked on the queue (sum)
    depth_hwm: int = 0   #: max items resident ahead of the consumer

    @property
    def overlap_pct(self) -> float:
        """Share of transfer time hidden behind compute, in percent:
        100 when the consumer never waited, 0 when every transfer second
        was paid for in consumer wait time."""
        if self.feed_s <= 0.0:
            return 100.0
        return 100.0 * max(0.0, 1.0 - self.wait_s / self.feed_s)


@dataclasses.dataclass
class Fed:
    """One item after a CUDA transfer: ``item`` with its numeric columns
    replaced by tensors on ``device`` that are valid once ``event`` has
    run."""

    item: tuple
    event: torch.cuda.Event
    device: torch.device


class CudaTransfer:
    """``transfer`` for :func:`feed` onto a CUDA device.

    Called on the feeder's worker thread with a tuple; the numpy arrays
    at ``columns`` go to ``device`` through pinned host buffers and
    ``non_blocking`` copies on a side stream that the worker creates on
    first use, and the call returns a :class:`Fed`. Each call takes
    fresh pinned buffers from PyTorch's caching host allocator, which
    records the copy on each buffer and reuses none before its copy has
    finished, so no buffer is refilled while its copy is in flight.
    """

    def __init__(self, device, columns: tuple):
        self.device = torch.device(device)
        self.columns = columns
        self._stream = None

    def __call__(self, item: tuple) -> Fed:
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            out = list(item)
            with torch.cuda.stream(self._stream):
                for i in self.columns:
                    col = item[i]
                    if isinstance(col, np.ndarray):
                        out[i] = _pinned_copy(col, self.device)
            event = torch.cuda.Event()
            event.record(self._stream)
        return Fed(tuple(out), event, self.device)


def _pinned_copy(col: np.ndarray, device) -> torch.Tensor:
    """``col`` through a fresh pinned host buffer onto ``device``, as a
    ``non_blocking`` copy on the current stream."""
    pinned = torch.empty(col.shape, pin_memory=True,
                         dtype=torch.from_numpy(col[:0].copy()).dtype)
    pinned.numpy()[...] = col
    return pinned.to(device, non_blocking=True)


@dataclasses.dataclass
class FedColumns:
    """One column batch after a :class:`CudaColumns` transfer: ``cols``
    is the batch as the source gave it (host arrays, which the content
    hash and the journal read), ``device`` the kept rows' numeric
    columns on the card (which the cascade reads)."""

    cols: dict
    device: dict


class CudaColumns:
    """``transfer`` for :func:`feed` of column dicts onto a CUDA device:
    the counterpart of the JAX package's ``device_put_columns``.

    The float columns among ``columns`` (``latitude``, ``longitude`` and
    ``value`` by default) of the rows the ingest filter keeps
    (``pipeline.batch.kept_rows``) go to ``device`` as float64 through
    pinned buffers on the worker's side stream, as in
    :class:`CudaTransfer`. The call returns a :class:`Fed` whose item is
    a :class:`FedColumns` holding the untouched host dict beside the
    tensors, so nothing downstream copies a fed batch back to the host.
    """

    def __init__(self, device, columns=("latitude", "longitude", "value")):
        self.device = torch.device(device)
        self.columns = columns
        self._stream = None

    def __call__(self, cols: dict) -> Fed:
        from heatmap_tpu_torch.pipeline.batch import kept_rows

        idx = kept_rows(cols)
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            out = {}
            with torch.cuda.stream(self._stream):
                for name in self.columns:
                    col = cols.get(name)
                    if not (isinstance(col, np.ndarray)
                            and col.dtype.kind in "fiu"):
                        continue
                    col = np.asarray(col, np.float64)
                    if idx is not None:
                        col = col[idx]
                    out[name] = _pinned_copy(col, self.device)
            event = torch.cuda.Event()
            event.record(self._stream)
        return Fed(FedColumns(cols, out), event, self.device)


def ready(fed):
    """The consumer's side of :class:`CudaTransfer` and
    :class:`CudaColumns`: make the current stream wait for the copies,
    mark each tensor as used on that stream (so the caching allocator
    keeps its memory until the consumer's work on it is done, not just
    the side stream's), and return the item. Anything else passes
    through."""
    if not isinstance(fed, Fed):
        return fed
    stream = torch.cuda.current_stream(fed.device)
    stream.wait_event(fed.event)
    item = fed.item
    tensors = item.device.values() if isinstance(item, FedColumns) else item
    for col in tensors:
        if isinstance(col, torch.Tensor) and col.is_cuda:
            col.record_stream(stream)
    return item


def device_put_columns(cols, *, device, columns=("latitude", "longitude",
                                                "value")):
    """The batch dict with its numeric columns in ``columns`` moved to
    ``device`` as tensors (the JAX package's ``device_put_columns``; the
    device is named, never implied). Only ndarray float/int columns
    move: string columns and ``timestamp`` (the host-side timespan
    labeler reads it) stay as they are."""
    out = dict(cols)
    for name in columns:
        val = out.get(name)
        if isinstance(val, np.ndarray) and val.dtype.kind in "fiu":
            out[name] = torch.as_tensor(val, device=torch.device(device))
    return out


def feed(items, transfer, *, depth: int = DEFAULT_DEPTH,
         stats: FeederStats | None = None, thread_name: str = "feeder"):
    """Yield ``transfer(item)`` for each item, producing and transferring
    up to ``depth`` items ahead of the consumer on a worker thread (the
    worker also draws ``items`` itself, so their production overlaps the
    consumer too).

    ``transfer`` runs under the ``feeder.put`` fault site (retried per
    its policy; it must be idempotent). Items yield in source order. A
    worker exception (source or transfer, retries spent) re-raises here
    after the items already queued; a consumer exception stops the
    worker before it propagates.

    Returns a generator; pass a :class:`FeederStats` to read the overlap
    numbers during or after the drain.
    """
    if depth < 1:
        raise ValueError(f"feeder depth must be >= 1, got {depth}")
    st = stats if stats is not None else FeederStats()
    q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
    abort = threading.Event()
    worker_error: list = []

    def _put(payload) -> bool:
        while not abort.is_set():
            try:
                q.put(payload, timeout=_POLL_S)
                return True
            except queue_mod.Full:
                continue
        return False

    def _work():
        try:
            for index, item in enumerate(items):
                t0 = time.monotonic()
                fed = faults.retry_call(
                    transfer, item, site="feeder.put", key=index)
                st.feed_s += time.monotonic() - t0
                if not _put(fed):
                    return
            _put(_DONE)
        except BaseException as e:  # re-raised in the consumer
            worker_error.append(e)
            abort.set()

    # The worker's spans join the consumer's span tree.
    worker = threading.Thread(target=obs.tracing.context_bound(_work),
                              name=thread_name, daemon=True)
    worker.start()

    def _drain():
        metrics_on = obs.metrics_enabled()
        try:
            while True:
                t0 = time.monotonic()
                try:
                    got = q.get(timeout=_POLL_S)
                except queue_mod.Empty:
                    if abort.is_set():
                        break
                    st.wait_s += time.monotonic() - t0
                    continue
                st.wait_s += time.monotonic() - t0
                if got is _DONE:
                    break
                st.depth_hwm = max(st.depth_hwm, q.qsize() + 1)
                if metrics_on:
                    obs.FEEDER_DEPTH.set(q.qsize())
                st.batches += 1
                yield got
        finally:
            abort.set()
            worker.join(timeout=5.0)
        if worker_error:
            raise worker_error[0]

    return _drain()
