"""Predicate retraction: journal scan -> exact signed counter-batches.

The port's copy of heatmap_tpu/delta/retract.py; the counter-batches run
on the port's cascade (``device``), one per temporal bucket on a store
that pins a temporal config.

The per-batch mechanism has existed since the journal landed: submit
the same points with ``sign=-1`` and linearity cancels them exactly.
This module closes the GDPR-shaped other half — "delete everything
matching ``user=U``" when the caller no longer HAS the original
batches. The journal does: every entry stores its point columns
(journal.py encode_points), so a retraction is

1. scan retained entries, match rows against the predicate;
2. net the matches as a signed multiset (insert entries add, earlier
   counter entries subtract — re-running a retraction, or retracting
   after a partial one, never double-cancels);
3. group surviving rows by the temporal bucket of their entry's
   watermark (heatmap_tpu_torch.temporal) and by column signature;
4. apply one ``sign=-1`` counter-batch per group with the group's
   watermark as an explicit override, so each cancellation lands in
   the SAME bucket as the rows it removes — all-time AND every
   temporal fold converge to a clean recompute over survivors.

The scan horizon is the journal retention window: entries pruned after
compaction have no payload left, and entries from stores predating
point payloads never had one — both raise instead of silently
retracting less than the predicate asked for (docs/temporal.md).

Idempotent end to end: counter-batches are content-hashed (salted with
the watermark override), so re-running the same retraction re-nets to
zero surviving matches and applies nothing.
"""

from __future__ import annotations

import time

import numpy as np

from heatmap_tpu_torch import obs
from heatmap_tpu_torch.delta.compact import journal_dir, read_current
from heatmap_tpu_torch.delta.journal import DeltaJournal

#: Predicate aliases accepted by ``--where`` (CLI friendliness: the
#: serve tier calls user layers "layers").
_ALIASES = {"user": "user_id", "layer": "user_id"}
_FLOAT_COLS = ("latitude", "longitude", "value")
_OBJECT_COLS = ("user_id", "source", "timestamp")
_ROW_COLS = _FLOAT_COLS + _OBJECT_COLS


def parse_where(pairs) -> dict:
    """["user=alice", "source=gps"] -> canonical predicate dict."""
    where = {}
    for p in pairs:
        if "=" not in p:
            raise ValueError(f"--where wants column=value, got {p!r}")
        k, v = p.split("=", 1)
        k = _ALIASES.get(k, k)
        if k not in _ROW_COLS:
            raise ValueError(
                f"--where column {k!r} is not a point column "
                f"({', '.join(_ROW_COLS)})")
        where[k] = v
    if not where:
        raise ValueError("retraction needs at least one --where clause")
    return where


def _match_mask(cols: dict, where: dict, n: int) -> np.ndarray:
    mask = np.ones(n, bool)
    for k, v in where.items():
        col = cols.get(k)
        if col is None:
            return np.zeros(n, bool)  # column absent: nothing matches
        if k in _FLOAT_COLS:
            mask &= np.asarray(col, np.float64) == float(v)
        else:
            mask &= np.asarray(
                [str(c) for c in col], str) == str(v)
    return mask


def _row_key(cols: dict, i: int) -> tuple:
    out = []
    for k in _ROW_COLS:
        col = cols.get(k)
        if col is None:
            out.append(None)
        elif k in _FLOAT_COLS:
            out.append(float(np.asarray(col)[i]))
        else:
            out.append(col[i])
    return tuple(out)


def _config_from_current(root: str):
    """Rehydrate the byte-affecting cascade config from the CURRENT
    fingerprint — a retraction must aggregate its counter-batch with
    exactly the pinned pyramid shape, and the store already knows it."""
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    fp = read_current(root).get("config")
    if fp is None:
        raise ValueError(
            f"store {root} has no pinned config (no batch ever "
            "applied) — nothing to retract")
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in fp.items()}
    return BatchJobConfig(**kw)


def retract_predicate(root: str, where: dict, *, config=None,
                      batch_size: int = 1 << 20, device="cuda") -> dict:
    """Retract every journaled row matching ``where``; see module
    docstring. The counter-batches cascade on ``device``. Returns a
    summary dict (rows retracted, counter-batch epochs, scan
    horizon)."""
    from heatmap_tpu_torch.delta import (ColumnsSource, apply_batch,
                                         init_store)
    from heatmap_tpu_torch.temporal import buckets as tb

    t0 = time.monotonic()
    init_store(root)
    if config is None:
        config = _config_from_current(root)
    tcfg = read_current(root).get("temporal")
    if tcfg is not None:
        tcfg = tb.normalize_config(tcfg)
    journal = DeltaJournal(journal_dir(root))
    entries = journal.entries()
    # Net signed multiset per (bucket, column-signature) group.
    groups: dict = {}
    scanned = 0
    for e in entries:
        cols = journal.load_points(int(e["epoch"]))
        if cols is None:
            raise ValueError(
                f"journal entry epoch {e['epoch']} has no point "
                "payload (pre-payload store or pruned horizon) — "
                "cannot guarantee an exact predicate retraction; see "
                "docs/temporal.md")
        n = len(cols["latitude"])
        scanned += n
        mask = _match_mask(cols, where, n)
        if not mask.any():
            continue
        wm = e.get("watermark")
        if tcfg is not None and wm is not None:
            bucket = tb.bucket_of(float(wm), tcfg)[0]
        else:
            bucket = None
        sig = tuple(k for k in _ROW_COLS if cols.get(k) is not None)
        key = (bucket, sig)
        g = groups.setdefault(key, {"counts": {}, "watermark": None})
        if wm is not None:
            g["watermark"] = (wm if g["watermark"] is None
                              else max(g["watermark"], float(wm)))
        sgn = int(e.get("sign", 1))
        for i in np.flatnonzero(mask):
            rk = _row_key(cols, int(i))
            g["counts"][rk] = g["counts"].get(rk, 0) + sgn
    results = []
    rows_retracted = 0
    for (bucket, sig), g in sorted(
            groups.items(),
            key=lambda kv: (str(kv[0][0]), kv[0][1])):
        survivors = [(rk, c) for rk, c in sorted(g["counts"].items(),
                                                 key=lambda kv: str(kv[0]))
                     if c > 0]
        if not survivors:
            continue
        cols: dict = {k: [] for k in sig}
        for rk, count in survivors:
            for _ in range(count):
                for k, v in zip(_ROW_COLS, rk):
                    if k in cols:
                        cols[k].append(v)
        n = len(cols["latitude"])
        res = apply_batch(root, ColumnsSource(cols), config, sign=-1,
                          batch_size=batch_size,
                          watermark=g["watermark"], device=device)
        rows_retracted += 0 if res.duplicate else n
        results.append(res)
    seconds = time.monotonic() - t0
    epochs = [r.epoch for r in results if not r.duplicate]
    obs.emit("retraction_applied", root=root, rows=rows_retracted,
             batches=len(epochs), scanned=scanned,
             where={k: str(v) for k, v in sorted(where.items())},
             epochs=epochs, seconds=round(seconds, 6))
    return {"rows": rows_retracted, "batches": len(epochs),
            "epochs": epochs, "scanned": scanned,
            "entries": len(entries), "seconds": seconds,
            "results": results}
