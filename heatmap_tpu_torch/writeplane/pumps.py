"""Multi-writer ingest pumps over one write plane (the port's copy of
heatmap_tpu/writeplane/pumps.py).

One **router** + N **pumps**, one thread per range: the router drains a
source through the ingest loop's bounded producer/consumer queue
(``ingest.loop.run_ticks`` — the same back-pressure machinery, reused
verbatim), content-hashes each full micro-batch against the plane's
ledger, routes it by Morton ownership, and enqueues per-range
sub-batches into per-pump bounded queues. Each pump thread drains its
own queue: apply (``WritePlane.apply_range`` — the ``writeplane.append``
fault site + the range's own exactly-once journal), then the
``compact_every`` policy with the in-flight-depth guard.

A **coordinator** tracks per-batch completion: only when every routed
sub-apply landed is the batch recorded in the full-batch ledger, and
every ``publish_every`` finished batches (completed *or* failed) the
plane flips a manifest epoch — so a dead writer never stalls
visibility for the survivors.

Writer loss is survived, not masked: a pump whose apply raises
terminally (a killed writer, chaos ``writeplane.append@rNNN``) marks
itself dead and fast-fails its remaining queue items, so the router
never blocks on a corpse and the other ranges keep applying and
publishing. The dead range's batches are simply never ledgered;
re-running the same source after a restart heals them exactly-once —
survivors' sub-batches dedup in their range journals, the dead range
applies its missing halves, and the ledger records close
(tests/test_torch_writeplane.py pins the byte identity).

On the card every pump launches its range's cascade on the device's
current stream, the default one, so the device work of two pumps runs
one after the other; what overlaps is their host work (read, hash,
journal, artifact writes).
"""

from __future__ import annotations

import dataclasses
import itertools
import queue as queue_mod
import threading
import time

from heatmap_tpu_torch.delta.compute import ColumnsSource, read_columns
from heatmap_tpu_torch.delta.journal import batch_content_hash
from heatmap_tpu_torch.ingest.loop import run_ticks
from heatmap_tpu_torch.writeplane.plane import WritePlane, _watermark

_STOP = object()


@dataclasses.dataclass
class PumpStats:
    """One pump's (range's) view of the run."""

    applied: int = 0      #: sub-batches applied (new epochs)
    duplicates: int = 0   #: sub-batches the range journal deduped
    points: int = 0
    compactions: int = 0
    errors: int = 0
    dead: bool = False
    error: str | None = None


@dataclasses.dataclass
class PlaneStats:
    """The coordinator's view of one pumped run."""

    batches: int = 0      #: full batches the router saw
    completed: int = 0    #: fully applied + ledger-recorded
    duplicates: int = 0   #: full-batch ledger hits (never routed)
    failed: int = 0       #: >= 1 sub-apply failed (not ledgered)
    points: int = 0       #: points in completed batches
    publishes: int = 0
    publish_errors: int = 0
    epoch: int = 0        #: newest manifest epoch published
    seconds: float = 0.0
    lags_s: list = dataclasses.field(default_factory=list)
    pumps: dict = dataclasses.field(default_factory=dict)


class PlanePumps:
    """Router + per-range pump threads + completion coordinator."""

    def __init__(self, plane: WritePlane, *, queue_depth: int = 4,
                 publish_every: int = 1):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if publish_every < 1:
            raise ValueError(
                f"publish_every must be >= 1, got {publish_every}")
        self.plane = plane
        self.queue_depth = queue_depth
        self.publish_every = publish_every
        self.stats = PlaneStats()
        self._queues: dict = {}
        self._threads: dict = {}
        self._mu = threading.Lock()
        self._outstanding: dict = {}
        self._pending_lag: list = []
        self._finished_since_publish = 0
        self._dirty = False  # applies since the last manifest flip

    # -- pumps -------------------------------------------------------------

    def _ensure_pumps(self):
        for name in self.plane.order:
            if name not in self._queues:
                q: queue_mod.Queue = queue_mod.Queue(
                    maxsize=self.queue_depth)
                self._queues[name] = q
                self.stats.pumps[name] = PumpStats()
                t = threading.Thread(target=self._pump, args=(name,),
                                     name=f"writeplane-pump-{name}",
                                     daemon=True)
                self._threads[name] = t
                t.start()

    def _pump(self, name: str):
        q = self._queues[name]
        ps = self.stats.pumps[name]
        while True:
            item = q.get()
            try:
                if item is _STOP:
                    return
                try:
                    self._pump_one(name, q, ps, *item)
                except BaseException as e:  # noqa: BLE001 — keep the loop
                    # _pump_one already routes apply failures through
                    # the writer-loss path; anything escaping it is a
                    # coordinator/bookkeeping failure. If it killed the
                    # thread, the router's bounded queue for this range
                    # would fill and q.put would block forever — so
                    # reuse the writer-loss path: mark the pump dead
                    # (subsequent items fast-fail) and best-effort fail
                    # the part so the batch resolves instead of
                    # dangling in _outstanding.
                    ps.errors += 1
                    ps.dead = True
                    ps.error = repr(e)
                    try:
                        self._part_done(item[0], ok=False)
                    except BaseException:  # noqa: BLE001 — stay alive
                        pass
            finally:
                q.task_done()

    def _pump_one(self, name: str, q, ps: PumpStats, seq, sub, sign):
        if ps.dead:
            # Fast-fail so the router never blocks on a corpse.
            self._part_done(seq, ok=False)
            return
        try:
            res = self.plane.apply_range(name, sub, sign=sign)
        except BaseException as e:  # noqa: BLE001 — writer loss
            ps.errors += 1
            ps.dead = True
            ps.error = repr(e)
            self._part_done(seq, ok=False)
            return
        if res.duplicate:
            ps.duplicates += 1
        else:
            ps.applied += 1
            ps.points += res.points
        self._part_done(seq, ok=True)
        try:
            if self.plane.maybe_compact(
                    name, inflight=q.qsize()) is not None:
                ps.compactions += 1
        except Exception as e:  # noqa: BLE001 — defer, don't die
            ps.errors += 1
            ps.error = repr(e)

    # -- coordinator -------------------------------------------------------

    def _part_done(self, seq: int, *, ok: bool):
        with self._mu:
            # .get, not []: a batch can already be resolved when the
            # pump's failure handler re-fails a part (double-completion
            # must be a no-op, never a KeyError that kills the thread).
            ent = self._outstanding.get(seq)
            if ent is None:
                return
            ent["left"] -= 1
            if not ok:
                ent["failed"] = True
            if ent["left"] > 0:
                return
            del self._outstanding[seq]
        if ent["failed"]:
            with self._mu:
                self.stats.failed += 1
        else:
            # The commit point: every routed sub-apply landed, so the
            # full-batch hash enters the dedup ledger (atomic append).
            try:
                self.plane.record_batch(ent["hash"], points=ent["points"],
                                        sign=ent["sign"],
                                        watermark=ent["watermark"])
                with self._mu:
                    self.stats.completed += 1
                    self.stats.points += ent["points"]
                    self._pending_lag.append(ent["enqueued"])
            except Exception:  # noqa: BLE001 — replay re-ledgers it
                with self._mu:
                    self.stats.failed += 1
        self._finished_one()

    def _finished_one(self):
        with self._mu:
            self._dirty = True
            self._finished_since_publish += 1
            if self._finished_since_publish < self.publish_every:
                return
            self._finished_since_publish = 0
        self._publish()

    def _publish(self):
        with self._mu:
            if not self._dirty:
                return
            self._dirty = False
        try:
            epoch = self.plane.publish()
        except Exception:  # noqa: BLE001 — next cadence supersedes it
            with self._mu:
                self.stats.publish_errors += 1
                self._dirty = True
            return
        now = time.monotonic()
        with self._mu:
            self.stats.publishes += 1
            self.stats.epoch = epoch
            lags, self._pending_lag = self._pending_lag, []
        self.stats.lags_s.extend(now - t for t in lags)

    # -- run ---------------------------------------------------------------

    def run(self, source, *, micro_batch: int = 1 << 14, sign: int = 1,
            max_ticks: int | None = None,
            router_queue_depth: int | None = None) -> PlaneStats:
        """Drain ``source`` through the plane; blocks until every pump
        finished and a final manifest epoch covers everything applied.
        Safe to re-run with the same source after a crash or writer
        loss: the two dedup layers make the replay exactly-once."""
        t0 = time.monotonic()
        seq_counter = itertools.count()

        def _route_tick(batch, ctx):
            cols = read_columns(ColumnsSource(batch))
            self.plane.ensure_plan(cols)
            self._ensure_pumps()
            h = batch_content_hash(cols, sign=sign)
            with self._mu:
                self.stats.batches += 1
            if self.plane.ledger_find(h) is not None:
                with self._mu:
                    self.stats.duplicates += 1
                return
            parts = self.plane.route(cols)
            if not parts:  # empty batch: nothing to route, just ledger
                self.plane.record_batch(h, points=len(cols["latitude"]),
                                        sign=sign,
                                        watermark=_watermark(cols))
                with self._mu:
                    self.stats.completed += 1
                self._finished_one()
                return
            seq = next(seq_counter)
            with self._mu:
                self._outstanding[seq] = {
                    "left": len(parts), "failed": False, "hash": h,
                    "points": int(len(cols["latitude"])), "sign": sign,
                    "watermark": _watermark(cols),
                    "enqueued": ctx.enqueued_at}
            for name, sub in parts:
                self._queues[name].put((seq, sub, sign))

        items = source.batches(micro_batch)
        if max_ticks is not None:
            items = itertools.islice(items, max_ticks)
        try:
            run_ticks(items, _route_tick, queue_depth=router_queue_depth,
                      name="writeplane-router")
        finally:
            for q in self._queues.values():
                q.put(_STOP)
            for t in self._threads.values():
                t.join()
        self._publish()
        self.stats.seconds = time.monotonic() - t0
        return self.stats


def run_plane_ingest(plane: WritePlane, source, *,
                     micro_batch: int = 1 << 14, sign: int = 1,
                     queue_depth: int = 4, publish_every: int = 1,
                     max_ticks: int | None = None,
                     router_queue_depth: int | None = None) -> PlaneStats:
    """One pumped run over a source (the CLI/bench entry)."""
    pumps = PlanePumps(plane, queue_depth=queue_depth,
                       publish_every=publish_every)
    return pumps.run(source, micro_batch=micro_batch, sign=sign,
                     max_ticks=max_ticks,
                     router_queue_depth=router_queue_depth)
