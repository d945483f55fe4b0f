"""Incremental update engine: journaled deltas over an additive pyramid.

The port's copy of heatmap_tpu/delta. Stores are interchangeable: a
store written by ``python -m heatmap_tpu update`` continues under
``python -m heatmap_tpu_torch update`` and the reverse (same content
hashes, journal entries, config fingerprint, artifacts and compacted
base). Each applied batch runs the port's cascade on ``device`` (the
card unless the caller names the CPU). ``refresh_serving`` publishes
an applied batch to a live tile server (``serve/``).

The reference job recomputes all 16 levels from source on every run
(reference heatmap.py:152-158); because tile counts are pure sums, the
pyramid is an additively mergeable sketch, so new points only need to
touch the tiles they land in. This package turns the one-shot batch
job into a journaled, compacting pipeline:

- ``journal.py``  — content-hashed, epoch-numbered ingest journal
  (idempotent re-submits, signed entries for retractions).
- ``compute.py``  — a delta artifact is the ordinary cascade run over
  just the new points, in the columnar level format io/merge.py
  already merges.
- ``compact.py``  — base + delta stack overlaid on read; compaction
  folds deltas into a new base behind an atomic pointer flip and
  prunes behind a retention window.

``apply_batch`` is the ingest entry.

Correctness anchor (pinned in tests/test_delta.py): base ⊕ deltas is
byte-identical — at the served-blob level — to a full recompute over
the union of surviving points, before and after compaction.
"""

from __future__ import annotations

import dataclasses
import os
import time

from heatmap_tpu_torch import obs
from heatmap_tpu_torch.delta import compact as compact_mod
from heatmap_tpu_torch.delta.compact import (check_config, compact,
                                             config_fingerprint, init_store,
                                             live_entries,
                                             load_overlay_levels,
                                             overlay_dirs, read_current)
from heatmap_tpu_torch.delta.compute import (ColumnsSource,
                                             affected_tile_keys,
                                             compute_delta, read_columns)
from heatmap_tpu_torch.delta.journal import (DeltaJournal,
                                             batch_content_hash,
                                             entry_digest)
from heatmap_tpu_torch.delta.metrics import (COMPACTION_SECONDS,
                                             DELTA_APPLY_SECONDS,
                                             DELTA_POINTS)
from heatmap_tpu_torch.delta.recover import sweep
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.obs import tracing
from heatmap_tpu_torch.utils.trace import span

# retract imports back into this package lazily, so this import must
# stay below the names it uses (apply_batch is defined further down —
# the lazy function-body import in retract.py resolves it at call
# time, not here).
from heatmap_tpu_torch.delta.retract import parse_where, retract_predicate


@dataclasses.dataclass
class DeltaResult:
    """Outcome of one apply_batch call."""

    epoch: int
    points: int
    sign: int
    duplicate: bool
    artifact: str | None
    rows: int
    seconds: float
    affected_keys: set = dataclasses.field(default_factory=set)


def _watermark(cols) -> float | None:
    stamps = cols.get("timestamp")
    if stamps is None or not len(stamps):
        return None
    try:
        return max(float(t) for t in stamps if t is not None)
    except (TypeError, ValueError):
        return None


#: apply_batch sentinel: derive the watermark from the batch's own
#: timestamps (the default). Retraction passes an explicit override so
#: a counter-batch lands in the SAME temporal bucket as the entry it
#: cancels (heatmap_tpu.temporal) instead of at its submission time.
_AUTO_WATERMARK = object()


def apply_batch(root: str, source, config, *, sign: int = 1,
                batch_size: int = 1 << 20,
                watermark=_AUTO_WATERMARK, device="cuda",
                timer=None, device_columns: dict | None = None
                ) -> DeltaResult:
    """Journal + compute one incremental batch against a delta store.

    Idempotent: a batch whose content hash is already journaled is a
    no-op (no new epoch, no artifact written, no bytes changed, no
    kernel launched). ``sign=-1`` retracts the batch's points — an exact
    correction by linearity (the artifact carries negated counts). The
    cascade runs on ``device``; ``timer`` (a devices.StageTimer) gets its
    fenced stages. The default tracer records ``delta.read``,
    ``delta.hash``, ``delta.compute``, ``delta.journal`` and
    ``delta.keys`` spans.

    ``device_columns`` are the batch's numeric columns already on the
    card (the ingest loop's feeder): the cascade reads them, while the
    content hash and the journal entry read the source's host columns,
    so the hash is the one an unfed apply computes.
    """
    if sign not in (1, -1):
        raise ValueError("sign must be +1 (insert) or -1 (retraction)")
    # Root-on-demand: under a CLI `update` root this nests; a direct
    # apply_batch call with tracing on becomes its own connected tree.
    tsp = tracing.begin_span("delta.apply", {"sign": sign})
    try:
        t0 = time.monotonic()
        init_store(root)
        with span("delta.read"):
            cols = read_columns(source, batch_size=batch_size)
        salt = (None if watermark is _AUTO_WATERMARK
                else f"watermark={watermark}")
        with span("delta.hash"):
            content_hash = batch_content_hash(cols, sign=sign, salt=salt)
        journal = DeltaJournal(compact_mod.journal_dir(root))
        existing = journal.find(content_hash)
        if existing is not None:
            seconds = time.monotonic() - t0
            obs.emit("delta_applied", epoch=existing["epoch"],
                     points=existing["points"], sign=existing["sign"],
                     seconds=round(seconds, 6), duplicate=True,
                     content_hash=content_hash)
            return DeltaResult(epoch=existing["epoch"],
                               points=existing["points"],
                               sign=existing["sign"], duplicate=True,
                               artifact=existing.get("artifact"), rows=0,
                               seconds=seconds)
        check_config(root, config)
        n_points = int(len(cols["latitude"]))
        epoch = journal.next_epoch()
        artifact = f"delta-{epoch:06d}"
        out_dir = os.path.join(root, artifact)
        with span("delta.compute", items=n_points):
            stats = compute_delta(ColumnsSource(cols), out_dir, config,
                                  sign=sign, batch_size=batch_size,
                                  device=device, timer=timer,
                                  device_columns=device_columns)
        rows = int(stats.get("rows", 0)) if isinstance(stats, dict) else 0
        if watermark is _AUTO_WATERMARK:
            watermark = _watermark(cols)
        with span("delta.journal"):
            journal.append(content_hash=content_hash, points=n_points,
                           sign=sign, artifact=artifact,
                           watermark=watermark, cols=cols)
        with span("delta.keys"):
            keys = affected_tile_keys(LevelArraysSink.load(out_dir))
        seconds = time.monotonic() - t0
        DELTA_POINTS.inc(n_points, kind="insert" if sign > 0 else "retract")
        DELTA_APPLY_SECONDS.observe(seconds)
        obs.emit("delta_applied", epoch=epoch, points=n_points, sign=sign,
                 seconds=round(seconds, 6), content_hash=content_hash,
                 artifact=artifact, rows=rows, watermark=watermark,
                 keys_invalidated=len(keys))
        return DeltaResult(epoch=epoch, points=n_points, sign=sign,
                           duplicate=False, artifact=artifact, rows=rows,
                           seconds=seconds, affected_keys=keys)
    finally:
        tracing.end_span(tsp)


def refresh_serving(result: DeltaResult, store, cache=None) -> int:
    """Bring a live TileStore (mounted on this store's ``delta:`` spec)
    up to date after ``apply_batch`` — the targeted alternative to
    ``store.reload()``: the overlay index is rebuilt WITHOUT a
    generation bump (an additive delta cannot change untouched tiles'
    bytes, so their cache entries stay valid) and only the affected
    tile keys are invalidated, with their sliding-window variants (the
    cache tracks which window params it has served). Returns the number
    of cache entries dropped: the JAX package's count, found by testing
    the cache's keys against the result's ``TileKeySet`` instead of
    building the set (``TileCache.invalidate_matching``)."""
    if result.duplicate:
        return 0
    store.refresh_layers()
    if cache is None:
        return 0
    params = getattr(cache, "window_params", lambda: ())()
    return cache.invalidate_matching(result.affected_keys, params)


__all__ = [
    "COMPACTION_SECONDS", "ColumnsSource", "DELTA_APPLY_SECONDS",
    "DELTA_POINTS", "DeltaJournal", "DeltaResult", "affected_tile_keys",
    "apply_batch", "batch_content_hash", "check_config", "compact",
    "compute_delta", "config_fingerprint", "entry_digest", "init_store",
    "live_entries",
    "load_overlay_levels", "overlay_dirs", "parse_where", "read_columns",
    "read_current", "refresh_serving", "retract_predicate", "sweep",
]
