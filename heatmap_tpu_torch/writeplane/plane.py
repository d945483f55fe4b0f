"""The partitioned multi-writer write plane (the port's copy of
heatmap_tpu/writeplane/plane.py; each routed sub-batch's cascade runs on
the plane's ``device``, the card unless the caller names the CPU).

``WritePlane`` shards the delta journal and delta store by the Morton
ranges ``parallel/partition.py`` plans: each range is an ordinary,
fully independent delta store (``ranges/rNNN/`` — its own journal,
apply loop, compaction, and recovery sweep), and incoming batches are
routed host-side by detail-zoom Morton code (``tilemath.mercator.
project_points_np`` + ``morton_encode_np`` — the exact projection the
cascade itself bins with, so routing and binning can never disagree).
Readers see the union through the epoch-unified manifest
(writeplane/manifest.py); cross-writer coordination is that one
pointer flip.

Correctness model (pinned in tests/test_torch_writeplane.py, against
the JAX package's plane):

- **Byte identity.** Every point belongs to exactly one range
  (``searchsorted`` ownership, the cascade's convention), so a
  boundary-straddling batch splits into per-range sub-batches whose
  union is the batch. Tile counts are pure sums and integer-valued
  counts are exact in f64, so merging all ranges' overlays re-sums the
  same cells a single-writer store holds — served blobs and level
  arrays come out byte-identical, retractions included (linearity).
- **Exactly-once, two layers.** Per range, ``delta.apply_batch``'s
  content-hash journal already dedups sub-batches — routing is
  deterministic for a fixed plan, so a replayed batch re-splits
  identically and each range no-ops its half. Across plan *changes*
  (rebalance moves a split, so a replay re-splits differently), the
  plane keeps a top-level **ledger**: a ``DeltaJournal`` over the
  un-split batch hash, recorded only after every routed sub-apply
  landed. A batch found in the ledger never routes at all, so the
  dedup window survives re-partitioning.
- **Crash anywhere.** Sub-applies and the ledger record are each
  atomic; a crash between them leaves a partially-applied batch whose
  replay is healed by the per-range layer (plan unchanged until the
  ledger record lands — ``rebalance`` is an explicit coordinator
  action, never implicit). Torn manifests quarantine + fall back to
  the last good epoch (writeplane/recover.py).

Rebalance is journal handoff + re-split: the hot range compacts (its
live journal folds into the base — the handoff), the base's detail
rows vote a weighted-median split (``partition.split_range_median``,
the planner's re-split move against materialized mass), and a fresh
empty range takes ownership of the right half. The parent keeps its
historical base — reads merge every range, so ownership handoff needs
no data movement — and the new manifest epoch records the new plan
plus the child's lineage (``parent``).
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import re
import threading
import time

import numpy as np

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.delta import DeltaResult
from heatmap_tpu_torch.delta import apply_batch as delta_apply_batch
from heatmap_tpu_torch.delta.compute import (ColumnsSource, TileKeySet,
                                             read_columns)
from heatmap_tpu_torch.delta.journal import DeltaJournal, batch_content_hash
from heatmap_tpu_torch.parallel.partition import (plan_partition,
                                                  split_range_median)
from heatmap_tpu_torch.tilemath.mercator import project_points_np
from heatmap_tpu_torch.tilemath.morton import (morton_encode_np,
                                               morton_range_shards_np)
from heatmap_tpu_torch.writeplane import manifest as manifest_mod
from heatmap_tpu_torch.writeplane.metrics import (
    WRITEPLANE_APPEND_SECONDS, WRITEPLANE_APPENDS, WRITEPLANE_MANIFEST_EPOCH,
    WRITEPLANE_POINTS, WRITEPLANE_PUBLISHES, WRITEPLANE_REBALANCES)

# The delta package re-exports its ``compact`` *function*, shadowing the
# submodule attribute — import the module itself by dotted name.
compact_mod = importlib.import_module("heatmap_tpu_torch.delta.compact")

#: Ledger entries have no artifact directory — the sentinel keeps
#: ``entry_digest`` a pure identity hash (the path never exists).
LEDGER_ARTIFACT = "-"

_RANGE_RE = re.compile(r"^r(\d{3})$")


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    """Write-plane parameters (the pyramid config stays a
    BatchJobConfig, shared by every range — delta/compact.py pins it
    per range on first apply)."""

    #: Ingest pumps = initial Morton ranges (rebalance can add more).
    n_writers: int = 2
    #: Per-range journal entries kept after compaction (the per-range
    #: exactly-once window — docs/write-plane.md).
    retention: int = 2
    #: Hard floor under ``retention``: a per-range compact below it is
    #: refused, because partitioning multiplies replay exposure (every
    #: range must cover the full redelivery horizon on its own).
    retention_floor: int = 2
    #: Live deltas per range before the pump compacts it (0 = never).
    compact_every: int = 0
    #: Full-batch ledger entries retained (the cross-rebalance dedup
    #: window; size it like retention — to the redelivery horizon).
    ledger_keep: int = 64
    #: Manifest snapshot files retained after a publish (readers pinned
    #: to an older epoch fall back within this window; snapshots are
    #: tiny JSON, so keep a generous history).
    manifest_keep: int = 8
    #: Skew threshold for rebalance: hottest range mass over mean.
    balance_factor: float = 1.25
    #: Partition-plan sample seed (determinism knob).
    seed: int = 0

    def __post_init__(self):
        if self.n_writers < 1:
            raise ValueError(f"n_writers must be >= 1, got {self.n_writers}")
        if self.retention_floor < 1:
            raise ValueError("retention_floor must be >= 1, got "
                             f"{self.retention_floor}")
        if self.retention < self.retention_floor:
            raise ValueError(
                f"retention {self.retention} is below retention_floor "
                f"{self.retention_floor}: the per-range dedup window must "
                "cover the redelivery horizon (docs/write-plane.md)")
        if self.ledger_keep < 1:
            raise ValueError(f"ledger_keep must be >= 1, got "
                             f"{self.ledger_keep}")
        if self.manifest_keep < 1:
            raise ValueError(f"manifest_keep must be >= 1, got "
                             f"{self.manifest_keep}")


@dataclasses.dataclass
class PlaneAppend:
    """Outcome of one full-batch append across its routed ranges."""

    content_hash: str
    points: int
    sign: int
    duplicate: bool          #: full-batch ledger hit — nothing routed
    results: dict            #: range name -> DeltaResult (routed ranges)
    seconds: float
    #: The routed ranges' affected keys, as one delta.compute.TileKeySet.
    affected_keys: set = dataclasses.field(default_factory=set)


def _watermark(cols) -> float | None:
    stamps = cols.get("timestamp")
    if stamps is None or not len(stamps):
        return None
    try:
        return max(float(t) for t in stamps if t is not None)
    except (TypeError, ValueError):
        return None


def _take_cols(cols: dict, idx: np.ndarray) -> dict:
    """Slice every column by row indices, preserving order and the
    ndarray-vs-list layout ColumnsSource accepts."""
    out = {}
    for k, v in cols.items():
        if isinstance(v, np.ndarray):
            out[k] = v[idx]
        else:
            out[k] = [v[i] for i in idx]
    return out


def _pad_cols(cols: dict, target: int) -> dict:
    """Pad a routed sub-batch to ``target`` rows with masked-invalid
    lanes: NaN lat/lon project invalid (tilemath.mercator), so the
    cascade drops the pad lanes exactly as ``bucketing.pad_emissions``
    drops its own — byte-neutral by the same masking contract.

    Routed sub-batch sizes vary every tick (a range owns whatever
    share of each micro-batch lands in its interval), and the
    pre-bucketing pipeline stages (projection jit, emission assembly)
    compile per distinct *point* count — without this pad an N-writer
    plane pays a fresh XLA compile on nearly every apply. Padding is a
    pure function of the sub-batch length, so a crash replay re-pads
    identically and the range journal's content hash still dedups.
    """
    n = len(cols["latitude"])
    pad = target - n
    if pad <= 0:
        return cols
    out = {}
    for k, v in cols.items():
        if isinstance(v, np.ndarray):
            fill = (np.full(pad, np.nan, np.float64)
                    if k in ("latitude", "longitude")
                    else np.zeros(pad, np.asarray(v).dtype))
            out[k] = np.concatenate([np.asarray(v), fill])
        else:
            filler = {"user_id": "x-pad", "source": "pad"}.get(k, 0)
            out[k] = list(v) + [filler] * pad
    return out


class WritePlane:
    """One write-plane root: N range stores + manifest + ledger.

    Thread-safe: per-range applies may run concurrently (pumps.py);
    plan/manifest/ledger mutations serialize on one re-entrant lock.
    Every routed sub-batch's cascade runs on ``device`` (``"cuda"``, the
    default, or ``"cpu"``); pump threads launch on that device's current
    stream.
    """

    def __init__(self, root: str, config, plane: PlaneConfig | None = None,
                 *, device="cuda"):
        from heatmap_tpu_torch.writeplane import recover as recover_mod

        self.root = root
        self.config = config
        self.plane = plane or PlaneConfig()
        self.device = device
        self._lock = threading.RLock()
        os.makedirs(root, exist_ok=True)
        os.makedirs(os.path.join(root, manifest_mod.RANGES_DIRNAME),
                    exist_ok=True)
        os.makedirs(manifest_mod.ledger_dir(root), exist_ok=True)
        recover_mod.sweep_plane(root)
        self._ledger = DeltaJournal(manifest_mod.ledger_dir(root))
        self._splits: list | None = None
        self._order: list = []
        self._points: dict = {}
        self._parents: dict = {}
        self._epoch = 0
        snap = manifest_mod.read_manifest(root)
        if snap is not None:
            plan_dz = int(snap["plan"]["detail_zoom"])
            if config is not None and plan_dz != int(config.detail_zoom):
                raise ValueError(
                    f"write plane {root} was planned at detail_zoom "
                    f"{plan_dz}; refusing a config with detail_zoom "
                    f"{config.detail_zoom}")
            self._epoch = int(snap["epoch"])
            self._splits = [int(s) for s in snap["plan"]["splits"]]
            self._order = list(snap["order"])
            for name, entry in snap.get("ranges", {}).items():
                self._points[name] = int(entry.get("points", 0))
                if entry.get("parent"):
                    self._parents[name] = entry["parent"]
            # Heal a stale manifest: if the pointed epoch references a
            # pruned base/delta dir (a crash landed between a per-range
            # compact and the follow-up publish), republish from each
            # range's CURRENT — the per-range source of truth.
            if self._manifest_stale(snap):
                with self._lock:
                    self._publish_locked()

    def _manifest_stale(self, snap: dict) -> bool:
        """True when the snapshot references an artifact dir that no
        longer exists (compaction pruned it before the next publish)."""
        for name in snap.get("order", ()):
            entry = snap.get("ranges", {}).get(name, {})
            rroot = self.range_root(name)
            dirs = []
            if entry.get("base"):
                dirs.append(entry["base"])
            dirs.extend(entry.get("deltas", ()))
            for d in dirs:
                if not os.path.isdir(os.path.join(rroot, d)):
                    return True
        return False

    # -- plan / routing ----------------------------------------------------

    @property
    def planned(self) -> bool:
        return self._splits is not None

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def order(self) -> list:
        with self._lock:
            return list(self._order)

    @property
    def splits(self) -> list:
        with self._lock:
            return list(self._splits or [])

    def range_root(self, name: str) -> str:
        return manifest_mod.range_root(self.root, name)

    def _codes(self, cols):
        lat = np.asarray(cols["latitude"], np.float64)
        lon = np.asarray(cols["longitude"], np.float64)
        row, col, valid = project_points_np(lat, lon,
                                            int(self.config.detail_zoom))
        return morton_encode_np(row, col), valid

    def ensure_plan(self, cols: dict):
        """Plan the Morton ranges from the first batch's sampled codes
        (skew-resistant quantile split — parallel/partition.py), create
        the range stores, and publish manifest epoch 1. No-op once
        planned; a restart adopts the persisted plan instead."""
        if self._splits is not None:
            return
        codes, valid = self._codes(cols)
        plan = plan_partition(codes, self.plane.n_writers,
                              detail_zoom=int(self.config.detail_zoom),
                              valid=valid, seed=self.plane.seed,
                              balance_factor=self.plane.balance_factor)
        with self._lock:
            if self._splits is not None:
                return
            self._splits = [int(s) for s in plan.splits]
            self._order = [f"r{i:03d}"
                           for i in range(len(self._splits) + 1)]
            for name in self._order:
                compact_mod.init_store(self.range_root(name))
            self._publish_locked()

    def route(self, cols: dict) -> list:
        """Split a normalized column batch into (range_name, sub_cols)
        parts by detail-zoom Morton ownership. Deterministic for a
        fixed plan; row order is preserved within each part, so a
        replayed batch re-splits into byte-identical sub-batches.
        Invalid (out-of-projection) rows ride range 0 — the cascade
        drops them there exactly as a single writer would.

        The (splits, order) pair is snapshotted under the plane lock so
        a concurrent ``rebalance`` (which mutates both) can never be
        observed half-applied — routing sees either the old plan or the
        new one, whole."""
        with self._lock:
            if self._splits is None:
                raise ValueError("write plane has no partition plan yet "
                                 "(ensure_plan runs on the first append)")
            splits = np.asarray(self._splits, np.int64)
            order = tuple(self._order)
        codes, valid = self._codes(cols)
        shards = morton_range_shards_np(splits, codes)
        shards = np.where(np.asarray(valid, bool), shards, 0)
        parts = []
        for k, name in enumerate(order):
            idx = np.flatnonzero(shards == k)
            if len(idx):
                parts.append((name, _take_cols(cols, idx)))
        return parts

    # -- append ------------------------------------------------------------

    def ledger_find(self, content_hash: str):
        with self._lock:
            return self._ledger.find(content_hash)

    def record_batch(self, content_hash: str, *, points: int, sign: int,
                     watermark=None) -> dict:
        """Ledger a fully-applied batch (idempotent). Only call after
        every routed sub-apply landed — the ledger hit short-circuits
        routing, so a premature record would lose the tail ranges.

        Serialized on the plane lock: ``DeltaJournal.append`` is a
        non-atomic find → next_epoch → rename sequence, so two batches
        completing on different pump threads could otherwise claim the
        same epoch and the later rename would silently drop the
        earlier batch's hash from the exactly-once ledger (and the
        prune in ``_publish_locked`` could race an append and shrink
        the keep window by one)."""
        with self._lock:
            return self._ledger.append(content_hash=content_hash,
                                       points=points, sign=sign,
                                       artifact=LEDGER_ARTIFACT,
                                       watermark=watermark)

    def apply_range(self, name: str, cols: dict, *, sign: int = 1,
                    batch_size: int = 1 << 20) -> DeltaResult:
        """One routed sub-batch into one range store, under the
        ``writeplane.append`` fault site. Idempotent end to end (the
        range's own content-hash journal), so the retry policy is safe
        by construction."""
        rroot = self.range_root(name)
        n_real = int(len(cols["latitude"]))
        if getattr(self.config, "pad_bucketing", "exact") != "exact":
            from heatmap_tpu_torch.pipeline import bucketing

            cols = _pad_cols(cols, bucketing.bucket_size(
                n_real, self.config.pad_bucketing,
                self.config.pad_bucket_min))

        def _apply():
            return delta_apply_batch(rroot, ColumnsSource(cols),
                                     self.config, sign=sign,
                                     batch_size=batch_size,
                                     device=self.device)

        try:
            res = faults.retry_call(_apply, site="writeplane.append",
                                    key=name)
        except BaseException:
            WRITEPLANE_APPENDS.inc(range=name, status="error")
            raise
        if res.points != n_real:  # report real points, not pad lanes
            res = dataclasses.replace(res, points=n_real)
        if not res.duplicate:
            with self._lock:
                self._points[name] = (self._points.get(name, 0)
                                      + n_real)
            WRITEPLANE_POINTS.inc(n_real, range=name)
        WRITEPLANE_APPENDS.inc(
            range=name, status="duplicate" if res.duplicate else "applied")
        return res

    def append_columns(self, cols: dict, *, sign: int = 1,
                       batch_size: int = 1 << 20) -> PlaneAppend:
        """Route + apply one full batch synchronously (the pump-less
        path; pumps.py parallelizes the per-range applies)."""
        if sign not in (1, -1):
            raise ValueError("sign must be +1 (insert) or -1 (retraction)")
        t0 = time.monotonic()
        self.ensure_plan(cols)
        content_hash = batch_content_hash(cols, sign=sign)
        existing = self.ledger_find(content_hash)
        n_points = int(len(cols["latitude"]))
        if existing is not None:
            seconds = time.monotonic() - t0
            obs.emit("writeplane_append", points=existing["points"],
                     ranges=0, sign=sign, duplicate=True,
                     seconds=round(seconds, 6), content_hash=content_hash)
            return PlaneAppend(content_hash=content_hash,
                               points=existing["points"], sign=sign,
                               duplicate=True, results={}, seconds=seconds)
        results = {}
        keys = TileKeySet()
        for name, sub in self.route(cols):
            res = self.apply_range(name, sub, sign=sign,
                                   batch_size=batch_size)
            results[name] = res
            keys = keys | res.affected_keys
        self.record_batch(content_hash, points=n_points, sign=sign,
                          watermark=_watermark(cols))
        seconds = time.monotonic() - t0
        WRITEPLANE_APPEND_SECONDS.observe(seconds)
        obs.emit("writeplane_append", points=n_points, ranges=len(results),
                 sign=sign, duplicate=False, seconds=round(seconds, 6),
                 content_hash=content_hash)
        return PlaneAppend(content_hash=content_hash, points=n_points,
                           sign=sign, duplicate=False, results=results,
                           seconds=seconds, affected_keys=keys)

    def append(self, source, *, sign: int = 1,
               batch_size: int = 1 << 20) -> PlaneAppend:
        """Drain a source into one routed batch (read_columns
        normalizes exactly as delta.apply_batch would, so the ledger
        hash matches a single-writer run's journal hash)."""
        cols = read_columns(source, batch_size=batch_size)
        return self.append_columns(cols, sign=sign, batch_size=batch_size)

    # -- publish / compact -------------------------------------------------

    def publish(self) -> int:
        """Flip one manifest epoch: snapshot every range's CURRENT +
        live journal into an immutable manifest file and point MANIFEST
        at it (writeplane.publish fault site). This is the only
        cross-range coordination point — and the only moment new
        applies become reader-visible through a ``writeplane:`` store."""
        with self._lock:
            return self._publish_locked()

    def _publish_locked(self) -> int:
        t0 = time.monotonic()
        epoch = self._epoch + 1
        ranges = {}
        live_total = 0
        for name in self._order:
            rroot = self.range_root(name)
            cur = compact_mod.read_current(rroot)
            live = compact_mod.live_entries(rroot)
            live_total += len(live)
            entry = {"base": cur.get("base"),
                     "deltas": [e["artifact"] for e in live],
                     "applied_through": int(cur.get("applied_through", 0)),
                     "points": int(self._points.get(name, 0))}
            if self._parents.get(name):
                entry["parent"] = self._parents[name]
            ranges[name] = entry
        snap = {"schema": manifest_mod.MANIFEST_SCHEMA, "epoch": epoch,
                "plan": {"detail_zoom": int(self.config.detail_zoom),
                         "splits": [int(s) for s in self._splits or []]},
                "order": list(self._order), "ranges": ranges}
        faults.retry_call(manifest_mod.write_snapshot, self.root, snap,
                          site="writeplane.publish", key="manifest")
        self._epoch = epoch
        self._ledger.prune(applied_through=self._ledger.latest_epoch(),
                           retention=self.plane.ledger_keep)
        for old in manifest_mod.list_epochs(self.root):
            if old <= epoch - self.plane.manifest_keep:
                try:
                    os.unlink(manifest_mod.manifest_path(self.root, old))
                except OSError:
                    pass
        seconds = time.monotonic() - t0
        WRITEPLANE_PUBLISHES.inc()
        WRITEPLANE_MANIFEST_EPOCH.set(epoch)
        obs.emit("writeplane_publish", epoch=epoch,
                 ranges=len(self._order), seconds=round(seconds, 6),
                 live_deltas=live_total)
        return epoch

    def compact_range(self, name: str, *, retention: int | None = None,
                      inflight: int = 0) -> dict:
        """Per-range fold, guarded by the per-range exactly-once
        window: a retention below the plane's floor, or below the
        range's in-flight journal depth, is refused (ValueError) —
        pruning would forget hashes a pump can still replay."""
        retention = (self.plane.retention if retention is None
                     else int(retention))
        if retention < self.plane.retention_floor:
            raise ValueError(
                f"writeplane range {name}: retention {retention} is below "
                f"the per-range floor {self.plane.retention_floor} — the "
                "dedup window must cover every batch a pump can replay "
                "(docs/write-plane.md)")
        summary = compact_mod.compact(self.range_root(name),
                                      retention=retention, inflight=inflight)
        if summary.get("status") == "ok":
            # Compaction pruned dirs the current manifest epoch may
            # still reference; republish immediately so readers never
            # dwell on a snapshot with missing artifacts. (A crash in
            # the gap is healed by the staleness check at init.)
            with self._lock:
                self._publish_locked()
        return summary

    def maybe_compact(self, name: str, *, inflight: int = 0):
        """The pump's compaction policy: fold when ``compact_every``
        live deltas accumulated, unless the in-flight depth exceeds the
        retention window (deferred, never forced — the next quiet tick
        retries)."""
        every = self.plane.compact_every
        if not every:
            return None
        if inflight > self.plane.retention:
            return None  # window would not cover the queue; defer
        if len(compact_mod.live_entries(self.range_root(name))) < every:
            return None
        return self.compact_range(name, inflight=inflight)

    # -- rebalance ---------------------------------------------------------

    def _range_bounds(self, index: int) -> tuple:
        total = 1 << (2 * int(self.config.detail_zoom))
        splits = self._splits or []
        lo = int(splits[index - 1]) if index > 0 else 0
        hi = int(splits[index]) if index < len(splits) else total
        return lo, hi

    def _next_range_name(self) -> str:
        rdir = os.path.join(self.root, manifest_mod.RANGES_DIRNAME)
        nums = [int(n[1:]) for n in self._order]
        try:
            nums += [int(m.group(1)) for m in
                     (_RANGE_RE.match(n) for n in os.listdir(rdir)) if m]
        except OSError:
            pass
        return f"r{(max(nums) + 1 if nums else 0):03d}"

    def rebalance(self, *, force_range: str | None = None,
                  reason: str = "skew", inflight: int = 0) -> dict | None:
        """Hot-range re-split: journal handoff (compact folds the hot
        range's live journal into its base) + a weighted-median split
        of its materialized detail mass + a fresh empty range owning
        the right half, published as a new manifest epoch under the
        ``writeplane.rebalance`` fault site.

        Returns a summary dict, or None when no range exceeds
        ``balance_factor`` times the mean applied mass (or the hot
        range is a single-code irreducible hotspot). ``force_range``
        skips the skew check (the operator runbook's knob).

        ``inflight`` is the hot range's queued-but-unapplied batch
        depth (a pump's queue size; 0 after a drain). The handoff
        compact runs through :meth:`compact_range`, so the per-range
        retention floor and in-flight guard apply to it exactly as to
        a pump-triggered fold; a rebalance whose handoff would shrink
        the dedup window below the queue is deferred (returns None)
        rather than forced."""
        if inflight > self.plane.retention:
            return None  # handoff would prune under queued batches; defer
        with self._lock:
            if self._splits is None:
                return None
            masses = [self._points.get(n, 0) for n in self._order]
            total = sum(masses)
            if force_range is not None:
                if force_range not in self._order:
                    raise ValueError(f"unknown range {force_range!r}; "
                                     f"have {self._order}")
                hot_i = self._order.index(force_range)
            else:
                if total == 0:
                    return None
                mean = total / len(self._order)
                hot_i = int(np.argmax(masses))
                if masses[hot_i] <= self.plane.balance_factor * mean:
                    return None
            hot = self._order[hot_i]
            lo, hi = self._range_bounds(hot_i)
            t0 = time.monotonic()

            def _resplit():
                # Handoff: fold the hot range's live journal into its
                # base so the split votes on everything applied (and
                # the child starts from an empty store — the parent's
                # base keeps serving both halves' history by merge).
                # Through compact_range so the retention-floor and
                # in-flight-depth guards cover the handoff too.
                self.compact_range(hot, inflight=inflight)
                levels = compact_mod.load_overlay_levels(
                    self.range_root(hot))
                dz = int(self.config.detail_zoom)
                codes, weights = [], []
                for lvl in levels:
                    if int(lvl["zoom"]) != dz:
                        continue
                    codes.append(morton_encode_np(
                        np.asarray(lvl["row"], np.int64),
                        np.asarray(lvl["col"], np.int64)))
                    weights.append(np.abs(np.asarray(lvl["value"],
                                                     np.float64)))
                if not codes:
                    return None
                split = split_range_median(np.concatenate(codes),
                                           np.concatenate(weights), lo, hi)
                if split is None:
                    return None
                new_name = self._next_range_name()
                compact_mod.init_store(self.range_root(new_name))
                return split, new_name

            out = faults.retry_call(_resplit, site="writeplane.rebalance",
                                    key=hot)
            if out is None:
                return None
            split, new_name = out
            self._splits.insert(hot_i, int(split))
            self._order.insert(hot_i + 1, new_name)
            self._parents[new_name] = hot
            # Halve the mass estimate so the skew signal re-arms from
            # the post-split shape instead of instantly re-firing.
            half = masses[hot_i] // 2
            self._points[hot] = half
            self._points[new_name] = masses[hot_i] - half
            epoch = self._publish_locked()
            seconds = time.monotonic() - t0
            WRITEPLANE_REBALANCES.inc()
            obs.emit("writeplane_rebalance", range=hot, new_range=new_name,
                     split=int(split), reason=reason,
                     seconds=round(seconds, 6))
            return {"range": hot, "new_range": new_name,
                    "split": int(split), "epoch": epoch,
                    "reason": reason, "seconds": seconds}


def refresh_serving(result: PlaneAppend, store, cache=None) -> int:
    """Bring a live TileStore (mounted on this plane's ``writeplane:``
    spec) up to date after an append **and** publish — the targeted
    alternative to ``store.reload()``, same contract as
    ``delta.refresh_serving``: no generation bump, only the union of
    the routed ranges' affected tile keys invalidated. Returns cache
    entries dropped. (The store re-reads the manifest, so publish
    first — an unpublished apply is invisible by design.)"""
    if result.duplicate or not result.results:
        return 0
    store.refresh_layers()
    if cache is None:
        return 0
    # invalidate_keys' drop set, tested against the cache's keys instead
    # of building the key set (delta.refresh_serving).
    return cache.invalidate_matching(result.affected_keys)
