"""LSM-style maintenance for the delta store.

The port's copy of heatmap_tpu/delta/compact.py: the same store layout,
CURRENT pointer and config fingerprint, so a store written by either
package continues in the other, and compaction writes the same base
(levels, synopses, integrals, and tilefs mirrors when the old base
carried them), with the temporal bucket partition and its
``TEMPORAL.json`` manifest on a store that pins a temporal config.

Store layout (one directory, self-describing):

    root/
      CURRENT            atomic JSON pointer {base, applied_through,
                         config} — the only mutable cell
      base-XXXXXX/       compacted base pyramid (LevelArraysSink dir),
                         named by the last epoch folded into it
      delta-XXXXXX/      one delta artifact per journaled epoch
      journal/           ckpt-<epoch>.npz entries (delta/journal.py)

Reads overlay base + live deltas (journal entries newer than
``applied_through``) through ``io.merge.merge_level_parts`` — the same
re-aggregation the multihost shard merge uses — then prune exact-zero
cells left by retractions, so the overlay is indistinguishable from a
full recompute over the surviving points.

Compaction writes the merged pyramid to a ``.tmp`` dir, publishes it to
its final ``base-XXXXXX`` name through ``utils.checkpoint.publish_dir``
(per-file fsync + rename + parent-dir fsync — the directory-shaped
``save_checkpoint`` contract), then atomically rewrites CURRENT (tmp +
fsync + os.replace + parent fsync). A crash at any point leaves either
the old pointer with the old base intact, or the new pointer with the
new base complete — never a half-merged store. Superseded bases and
journal entries older than the retention window are pruned afterwards;
garbage from a crashed pass (orphan ``*.tmp`` staging dirs, an
unflipped base) is quarantined by the recovery sweep
(delta/recover.py) that runs at the head of ``init_store`` and
``compact``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

from heatmap_tpu_torch import faults
from heatmap_tpu_torch.delta.journal import DeltaJournal
from heatmap_tpu_torch.io.merge import merge_level_dirs
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.utils.checkpoint import fsync_dir, publish_dir

CURRENT_SCHEMA = "heatmap-tpu.delta_store.v1"
JOURNAL_DIRNAME = "journal"

#: Quarantined garbage younger than this is never pruned regardless of
#: the retention count — a day is the operator's minimum window to
#: inspect what a chaotic run left behind (delta/recover.py).
QUARANTINE_MIN_AGE_S = 24 * 3600.0

#: Config fields that change pyramid bytes: every batch applied to a
#: store must agree on them or base ⊕ delta is meaningless. Runtime
#: knobs (cascade_backend, data_parallel, chunking) are byte-neutral
#: and deliberately excluded.
CONFIG_FIELDS = ("detail_zoom", "min_detail_zoom", "result_delta",
                 "timespans", "weighted", "amplify_all",
                 "first_timespan_only")


def journal_dir(root: str) -> str:
    return os.path.join(root, JOURNAL_DIRNAME)


def read_current(root: str) -> dict:
    """The store pointer; a missing CURRENT is an empty store."""
    try:
        with open(os.path.join(root, "CURRENT")) as f:
            return json.load(f)
    except FileNotFoundError:
        return {"schema": CURRENT_SCHEMA, "base": None,
                "applied_through": 0, "config": None}


def write_current(root: str, cur: dict):
    """Atomic pointer flip: tmp + fsync + os.replace + parent-dir
    fsync, the save_checkpoint contract. Runs under the
    ``compact.publish`` fault site + retry policy — the flip is atomic,
    so a retried attempt lands the pointer exactly once."""

    def _flip():
        fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(cur, f, indent=2, sort_keys=True)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(root, "CURRENT"))
            fsync_dir(root)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    faults.retry_call(_flip, site="compact.publish", key="current")


def init_store(root: str, base_dir: str | None = None) -> dict:
    """Create (or no-op on) a delta store root; optionally adopt an
    existing arrays artifact as the initial base (copied in, so the
    store owns its files and compaction can prune them).

    Runs the crash-recovery sweep first (delta/recover.py), so every
    apply starts from a store with no torn journal entries or orphan
    staging dirs — a batch whose entry was quarantined re-journals
    under a fresh epoch and applies cleanly."""
    from heatmap_tpu_torch.delta import recover

    os.makedirs(root, exist_ok=True)
    os.makedirs(journal_dir(root), exist_ok=True)
    recover.sweep(root)
    cur = read_current(root)
    if base_dir is not None:
        if cur.get("base"):
            raise ValueError(
                f"delta store {root} already has base {cur['base']!r}; "
                "refusing to overwrite it with --base")
        name = "base-000000"
        shutil.copytree(base_dir, os.path.join(root, name),
                        dirs_exist_ok=True)
        cur["base"] = name
    write_current(root, cur)
    return cur


def config_fingerprint(config) -> dict:
    out = {}
    for field in CONFIG_FIELDS:
        v = getattr(config, field, None)
        out[field] = list(v) if isinstance(v, tuple) else v
    return out


def check_config(root: str, config) -> dict:
    """Pin the byte-affecting config on first apply; later applies must
    match it exactly (mixing zooms/timespans would corrupt the sums)."""
    cur = read_current(root)
    fp = config_fingerprint(config)
    if cur.get("config") is None:
        cur["config"] = fp
        write_current(root, cur)
    elif cur["config"] != fp:
        raise ValueError(
            f"delta store {root} was built with config {cur['config']}; "
            f"refusing to apply a batch with {fp}")
    return cur


def live_entries(root: str) -> list[dict]:
    """Journal entries not yet folded into the base, oldest first."""
    cur = read_current(root)
    journal = DeltaJournal(journal_dir(root))
    applied_through = int(cur.get("applied_through", 0))
    return [e for e in journal.entries() if e["epoch"] > applied_through]


def overlay_dirs(root: str) -> list[str]:
    """Level dirs the read path merges: current base + live deltas.
    Driven by CURRENT + the journal, never by globbing — an orphan
    artifact from a crashed apply (dir written, journal append lost)
    is invisible until its batch is retried."""
    cur = read_current(root)
    dirs = []
    if cur.get("base"):
        base = os.path.join(root, cur["base"])
        if os.path.isdir(base):
            dirs.append(base)
    for entry in live_entries(root):
        d = os.path.join(root, entry["artifact"])
        if os.path.isdir(d):
            dirs.append(d)
    return dirs


def drop_zero_rows(levels: list) -> list:
    """Remove exact-zero cells left by retractions.

    A full recompute over the surviving points never emits these rows,
    and the serve tier's JSON docs would otherwise carry spurious 0.0
    entries — breaking the byte-identity anchor. Counts cancel exactly
    in f64 (small integers), so ``== 0.0`` is precise, and it also
    catches -0.0.
    """
    out = []
    for lvl in levels:
        value = np.asarray(lvl["value"])
        keep = value != 0.0
        if keep.all():
            out.append(lvl)
            continue
        pruned = dict(lvl)
        for k in LevelArraysSink.COLUMNS:
            if k in pruned:
                pruned[k] = np.asarray(pruned[k])[keep]
        # Re-compact the name vocabularies: a fully-retracted user (or
        # timespan) must vanish from the name table too, or the bytes
        # diverge from the clean recompute (which derives names from
        # the rows it actually has). Dropping entries from a sorted
        # vocab keeps it sorted, so only the indices need remapping.
        for prefix in ("user", "timespan"):
            names = pruned.get(f"{prefix}_names")
            idx = pruned.get(f"{prefix}_idx")
            if names is None or idx is None:
                continue
            names = np.asarray(names)
            idx = np.asarray(idx)
            used = np.unique(idx)
            if len(used) == len(names):
                continue
            remap = np.full(len(names), -1, np.int32)
            remap[used] = np.arange(len(used), dtype=np.int32)
            # Rebuild through a list so the dtype re-tightens to the
            # widest SURVIVING name — a <U5 array keeping only "bob"
            # would otherwise differ on disk from the recompute's <U3.
            pruned[f"{prefix}_names"] = np.asarray(names[used].tolist())
            pruned[f"{prefix}_idx"] = remap[idx]
        out.append(pruned)
    return out


def load_overlay_levels(root: str) -> list:
    """base ⊕ live deltas as finalized level dicts (write_levels input
    format); [] for an empty store."""
    dirs = overlay_dirs(root)
    if not dirs:
        return []
    return drop_zero_rows(merge_level_dirs(dirs))


def _write_buckets(root: str, cur: dict, live: list, tmp_path: str,
                   tcfg: dict) -> dict:
    """Stage the temporal bucket partition inside the compaction tmp
    dir (heatmap_tpu_torch.temporal): carry the previous base's buckets
    forward, fold each live delta into the tier-0 bucket containing
    its watermark, coarsen old buckets up the geometric ladder, and
    write TEMPORAL.json — all under ``tmp_path`` so buckets and
    manifest publish atomically with the base itself.

    The top-level merged artifact is untouched: the all-time read path
    never sees buckets, which is what keeps it byte-identical to an
    un-bucketed store (the tier-1 identity gate); buckets are an
    additional, derived partition of the same journal entries.
    """
    from heatmap_tpu_torch.temporal import buckets as tb

    base_name = cur.get("base")
    prev = (tb.read_manifest(os.path.join(root, base_name))
            if base_name else None)
    timed: list[dict] = []
    none_dirs: list[str] = []
    none_epochs: list[int] = []
    none_points = 0
    if prev is not None:
        bdir = os.path.join(root, base_name, tb.BUCKETS_DIRNAME)
        for b in prev.get("buckets") or []:
            d = os.path.join(bdir, b["name"])
            if os.path.isdir(d):
                timed.append({"t0": float(b["t0"]), "t1": float(b["t1"]),
                              "tier": int(b.get("tier", 0)), "dirs": [d],
                              "epochs": list(b.get("epochs") or []),
                              "points": int(b.get("points", 0))})
        pn = prev.get("none")
        if pn is not None:
            d = os.path.join(bdir, tb.NONE_NAME)
            if os.path.isdir(d):
                none_dirs.append(d)
                none_epochs += list(pn.get("epochs") or [])
                none_points += int(pn.get("points", 0))
    elif base_name and os.path.isdir(os.path.join(root, base_name)):
        # Pre-temporal base: its history has no per-batch resolution
        # left, so it folds into the timeless bucket — the all-time
        # layer is preserved exactly; temporal cuts treat the legacy
        # rows as always-present (docs/temporal.md).
        none_dirs.append(os.path.join(root, base_name))
    for e in live:
        d = os.path.join(root, e["artifact"])
        if not os.path.isdir(d):
            continue
        wm = e.get("watermark")
        if wm is None:
            none_dirs.append(d)
            none_epochs.append(int(e["epoch"]))
            none_points += int(e.get("points", 0))
            continue
        t0, t1 = tb.bucket_of(float(wm), tcfg)
        timed.append({"t0": t0, "t1": t1, "tier": 0, "dirs": [d],
                      "epochs": [int(e["epoch"])],
                      "points": int(e.get("points", 0))})
    entries = []
    if timed:
        max_edge = max(u["t1"] for u in timed)
        plan = tb.plan_partition(timed, tcfg, max_edge)
        for (t0, t1, tier), members in sorted(plan.items()):
            dirs = [d for u in members for d in u["dirs"]]
            levels = drop_zero_rows(merge_level_dirs(dirs))
            if not any(len(lvl["row"]) for lvl in levels):
                continue  # fully cancelled by retraction: no bucket
            name = tb.bucket_name(t0, t1)
            out = os.path.join(tmp_path, tb.BUCKETS_DIRNAME, name)
            LevelArraysSink(out).write_levels(levels)
            entries.append({
                "name": name, "t0": t0, "t1": t1, "tier": int(tier),
                "epochs": sorted({ep for u in members
                                  for ep in u["epochs"]}),
                "points": sum(u["points"] for u in members),
                "digest": tb.bucket_digest(out),
            })
    else:
        max_edge = None
    none_entry = None
    if none_dirs:
        levels = drop_zero_rows(merge_level_dirs(none_dirs))
        if any(len(lvl["row"]) for lvl in levels):
            out = os.path.join(tmp_path, tb.BUCKETS_DIRNAME, tb.NONE_NAME)
            LevelArraysSink(out).write_levels(levels)
            none_entry = {"name": tb.NONE_NAME,
                          "epochs": sorted(set(none_epochs)),
                          "points": none_points,
                          "digest": tb.bucket_digest(out)}
    manifest = {"schema": tb.TEMPORAL_SCHEMA, "config": tcfg,
                "max_edge": max_edge, "buckets": entries,
                "none": none_entry}
    tb.write_manifest(tmp_path, manifest)
    return manifest


def compact(root: str, *, retention: int = 2, inflight: int = 0) -> dict:
    """Fold the live delta stack into a new base and prune.

    Returns a summary dict; a store with no live deltas is a no-op
    (compacting nothing would only rewrite the base it already has).

    ``inflight`` is the caller's in-flight journal depth — batches
    queued for this root but not yet journaled (a write-plane pump's
    queue, an ingest loop's backlog). A ``retention`` below it is
    refused: pruning would shrink the exactly-once dedup window under
    batches that can still be replayed against this store, turning a
    crash-replay into a double count (docs/ingest.md).
    """
    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.delta import recover
    from heatmap_tpu_torch.delta.metrics import COMPACTION_SECONDS
    from heatmap_tpu_torch.obs import tracing
    from heatmap_tpu_torch.tilefs import sniff_tilefs

    if inflight > 0 and retention < inflight:
        raise ValueError(
            f"compact({root}): retention {retention} is below the "
            f"in-flight journal depth {inflight} — refusing to shrink "
            "the exactly-once dedup window under queued batches "
            "(docs/ingest.md)")
    recover.sweep(root)
    cur = read_current(root)
    journal = DeltaJournal(journal_dir(root))
    live = live_entries(root)
    base_name = cur.get("base")
    if not live:
        return {"status": "noop", "base": base_name, "deltas": 0,
                "applied_through": int(cur.get("applied_through", 0))}
    obs.emit("compaction_start", root=root, deltas=len(live),
             base=base_name)
    t0 = time.monotonic()
    tsp = tracing.begin_span("delta.compact", {"deltas": len(live)})
    try:
        dirs = overlay_dirs(root)
        merged = drop_zero_rows(merge_level_dirs(dirs)) if dirs else []
        new_epoch = max(e["epoch"] for e in live)
        new_name = f"base-{new_epoch:06d}"
        new_path = os.path.join(root, new_name)
        # The sweep above quarantined any orphan tmp/base dirs from a
        # crashed pass, so both staging and final paths start absent.
        tmp_path = new_path + ".tmp"
        # synopses=True / integrals=True rebuild the wavelet synopsis
        # and summed-area artifacts from the MERGED pyramid into the
        # staging dir, so the published base atomically carries exact
        # levels, synopses, and integrals consistent with base ⊕
        # deltas (stale ones would violate the stamped error / exact-sum
        # contracts). tilefs mirrors are inherited: if the old base
        # carried them, the new base carries fresh ones too.
        keep_tilefs = bool(base_name) and sniff_tilefs(
            os.path.join(root, base_name))
        rows = LevelArraysSink(tmp_path, synopses=True, integrals=True,
                               tilefs=keep_tilefs).write_levels(merged)
        tcfg = cur.get("temporal")
        manifest = (_write_buckets(root, cur, live, tmp_path, tcfg)
                    if tcfg is not None else None)
        faults.retry_call(publish_dir, tmp_path, new_path,
                          site="compact.publish", key="base")
        cur = dict(cur)
        cur["base"] = new_name
        cur["applied_through"] = int(new_epoch)
        write_current(root, cur)  # the atomic commit point
        pruned = journal.prune(applied_through=new_epoch,
                               retention=retention)
        for entry in pruned:
            shutil.rmtree(os.path.join(root, entry["artifact"]),
                          ignore_errors=True)
        for name in os.listdir(root):
            if (name.startswith("base-") and name != new_name
                    and os.path.isdir(os.path.join(root, name))):
                shutil.rmtree(os.path.join(root, name),
                              ignore_errors=True)
        # Quarantine rides the same retention knob: keep the newest
        # ``retention`` quarantined items, but nothing younger than the
        # minimum age (an operator's incident-investigation window).
        recover.prune_quarantine(root, keep=retention,
                                 min_age_s=QUARANTINE_MIN_AGE_S)
        seconds = time.monotonic() - t0
        COMPACTION_SECONDS.observe(seconds)
        buckets = (len(manifest["buckets"]) +
                   (1 if manifest["none"] else 0)) if manifest else None
        extra = {"buckets": buckets} if buckets is not None else {}
        obs.emit("compaction_end", root=root, seconds=round(seconds, 6),
                 status="ok", base=new_name, levels=len(merged),
                 rows=int(rows), pruned_entries=len(pruned), **extra)
        return {"status": "ok", "base": new_name,
                "applied_through": int(new_epoch),
                "deltas": len(live), "levels": len(merged),
                "rows": int(rows), "pruned_entries": len(pruned),
                "buckets": buckets, "seconds": seconds}
    except BaseException as exc:
        obs.emit("compaction_end", root=root,
                 seconds=round(time.monotonic() - t0, 6),
                 status="error", error=repr(exc))
        raise
    finally:
        tracing.end_span(tsp)
