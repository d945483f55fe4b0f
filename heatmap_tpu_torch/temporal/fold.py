"""Partial-pyramid folds: select buckets for a temporal cut and merge.

The port's copy of heatmap_tpu/temporal/fold.py, on the port's
``delta.compact``, ``io.merge`` and ``LevelArraysSink``.

A fold is the temporal analogue of the all-time overlay
(delta/compact.py load_overlay_levels): pick the bucket dirs and live
delta artifacts inside the cut, merge them through the same
``io.merge`` re-aggregation core, drop exact-zero rows. Because the
pyramid is a pure sum and the merge is deterministic, a fold over ALL
buckets is byte-identical to the un-bucketed overlay — the fast tier-1
identity gate — and any sub-selection equals a clean recompute over
exactly the points whose batches landed inside the cut.

Cut semantics (batch-granular, aligned to bucket edges):

- ``as_of=T``  — cut at the largest bucket edge <= T; fold buckets
  ending at or before the cut plus live deltas whose watermark falls
  below it. History below a cut is immutable under ingest (new batches
  land above), so the fold token — and every cache entry keyed by it —
  survives unrelated writes; only retraction or compaction below the
  cut changes it.
- ``window=W`` — fold the trailing buckets whose end edge lies inside
  ``(ref - W, ref]`` where ``ref`` is the newest bucket edge (never
  wall clock: bytes must be a pure function of the data).
- decay       — per-bucket scalar weight ``0.5 ** ((ref - t1) /
  half_life)`` applied to bucket subtotals at fold time. Stored bytes
  are never restamped; linearity of the sum makes the weighted fold
  equal a clean recompute with per-point weight = its bucket's weight.

``bucket-none`` (batches with no timestamps) is timeless: included in
every fold with weight 1.0.

A selected bucket whose dir is missing or torn (quarantined by the
recovery sweep, or torn underneath us) raises ``TornBucketError`` —
the serve tier's stale-if-error cache then answers with the last good
bytes while the all-time path, which never reads buckets, is
unaffected (docs/robustness.md).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from heatmap_tpu_torch.delta.compact import (
    drop_zero_rows,
    live_entries,
    read_current,
    write_current,
)
from heatmap_tpu_torch.io.merge import _loaded_to_finalized, merge_level_parts
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.temporal import buckets as tb


class TornBucketError(RuntimeError):
    """A selected bucket (or live artifact) is missing or unreadable —
    the fold cannot be answered exactly; serve falls back to last-good
    cached bytes (stale-if-error) instead of folding garbage."""


def ensure_config(root: str, cfg: dict | None = None, **overrides):
    """Pin the temporal bucket config in CURRENT (byte-affecting for
    folds, same discipline as the cascade config fingerprint). First
    writer sets it; later writers must match exactly. Returns the
    active config, or None when the store has none and no config was
    offered."""
    cur = read_current(root)
    offered = None
    if cfg is not None or any(v is not None for v in overrides.values()):
        offered = tb.normalize_config(cfg, **overrides)
    existing = cur.get("temporal")
    if existing is None:
        if offered is None:
            return None
        cur = dict(cur)
        cur["temporal"] = offered
        write_current(root, cur)
        return offered
    existing = tb.normalize_config(existing)
    if offered is not None and offered != existing:
        raise ValueError(
            f"delta store {root} pinned temporal config {existing}; "
            f"refusing to proceed with {offered}")
    return existing


def temporal_config(root: str) -> dict | None:
    cfg = read_current(root).get("temporal")
    return tb.normalize_config(cfg) if cfg is not None else None


def _manifest_units(root: str, cur: dict):
    """(manifest bucket entries, none entry) of CURRENT's base."""
    base = cur.get("base")
    if not base:
        return [], None
    m = tb.read_manifest(os.path.join(root, base))
    if m is None:
        return [], None
    return list(m.get("buckets") or []), m.get("none")


def _live_units(root: str, cfg: dict):
    """Live journal entries tagged with their tier-0 bucket edges
    (t0/t1 None for watermark-less batches)."""
    out = []
    for e in live_entries(root):
        wm = e.get("watermark")
        if wm is None:
            t0 = t1 = None
        else:
            t0, t1 = tb.bucket_of(float(wm), cfg)
        out.append({"epoch": int(e["epoch"]), "artifact": e["artifact"],
                    "watermark": wm, "t0": t0, "t1": t1,
                    "sign": int(e.get("sign", 1))})
    return out


def newest_edge(root: str, cfg: dict | None = None) -> float | None:
    """The newest bucket edge the store's data reaches (max t1 over
    manifest buckets and live batches) — the temporal ``ref`` for
    window folds and decay. None for a store with no timestamped
    data."""
    if cfg is None:
        cfg = temporal_config(root)
    if cfg is None:
        return None
    cur = read_current(root)
    bucket_entries, _none = _manifest_units(root, cur)
    edges = [float(b["t1"]) for b in bucket_entries]
    edges += [u["t1"] for u in _live_units(root, cfg)
              if u["t1"] is not None]
    return max(edges) if edges else None


@dataclasses.dataclass(frozen=True)
class Selection:
    """A resolved temporal cut: which units fold, plus the token that
    names the fold (cache key component)."""

    buckets: tuple          # manifest bucket entries inside the cut
    live: tuple             # live unit dicts inside the cut
    none: dict | None       # bucket-none manifest entry (or None)
    ref: float | None       # decay/window reference edge
    lo: float | None        # exclusive lower cut (window), else None
    hi: float | None        # inclusive upper cut (as_of), else None
    token: str              # digest of the fold inputs


def select_fold(root: str, *, as_of: float | None = None,
                window: float | None = None,
                decay: float | None = None) -> Selection:
    """Resolve a temporal cut against the store's manifest + live
    journal. Raises ValueError when the store has no temporal config
    (buckets were never built — nothing to cut)."""
    cfg = temporal_config(root)
    if cfg is None:
        raise ValueError(
            f"store {root} has no temporal config — init it with "
            "ensure_config / the CLI --bucket-width flag before "
            "temporal queries")
    cur = read_current(root)
    bucket_entries, none_entry = _manifest_units(root, cur)
    live = _live_units(root, cfg)
    edges = sorted({float(b["t1"]) for b in bucket_entries}
                   | {u["t1"] for u in live if u["t1"] is not None})

    hi = None
    if as_of is not None:
        below = [e for e in edges if e <= float(as_of)]
        hi = below[-1] if below else None
    ref = hi if hi is not None else (edges[-1] if edges else None)
    lo = None
    if window is not None and ref is not None:
        lo = ref - float(window)

    def _in(t1) -> bool:
        if t1 is None:
            return False
        if hi is not None and t1 > hi:
            return False
        if as_of is not None and hi is None:
            return False  # as_of before all data: empty cut
        if lo is not None and t1 <= lo:
            return False
        return True

    sel_buckets = tuple(b for b in bucket_entries if _in(float(b["t1"])))
    sel_live = tuple(u for u in live if _in(u["t1"]))
    ident = {
        "buckets": sorted((b["name"], b.get("digest"))
                          for b in sel_buckets),
        "none": (none_entry or {}).get("digest"),
        "live": sorted(u["epoch"] for u in sel_live),
        "lo": lo, "hi": hi, "ref": ref,
        "decay": None if decay is None else float(decay),
    }
    token = hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()[:16]
    return Selection(buckets=sel_buckets, live=sel_live, none=none_entry,
                     ref=ref, lo=lo, hi=hi, token=token)


def _unit_dirs(root: str, cur: dict, sel: Selection):
    """[(dir, t1-or-None)] for every unit in the selection; missing
    dirs raise TornBucketError (quarantined bucket / vanished
    artifact)."""
    base = cur.get("base")
    out = []
    for b in sel.buckets:
        d = os.path.join(root, base or "", tb.BUCKETS_DIRNAME, b["name"])
        if not os.path.isdir(d):
            raise TornBucketError(
                f"bucket {b['name']} missing from base {base!r} "
                "(quarantined or torn)")
        out.append((d, float(b["t1"])))
    if sel.none is not None:
        d = os.path.join(root, base or "", tb.BUCKETS_DIRNAME,
                         tb.NONE_NAME)
        if not os.path.isdir(d):
            raise TornBucketError(
                f"{tb.NONE_NAME} missing from base {base!r}")
        out.append((d, None))
    for u in sel.live:
        d = os.path.join(root, u["artifact"])
        if not os.path.isdir(d):
            raise TornBucketError(
                f"live artifact {u['artifact']} missing")
        out.append((d, u["t1"]))
    return out


def decay_weight(t1: float | None, ref: float, half_life: float) -> float:
    """Per-bucket decay scalar; timeless units (t1 None) never age."""
    if t1 is None:
        return 1.0
    return float(0.5 ** ((float(ref) - float(t1)) / float(half_life)))


def fold_levels(root: str, sel: Selection, *,
                decay_half_life: float | None = None) -> list:
    """Merge the selection into finalized level dicts (write_levels
    input format, the shape load_overlay_levels returns). With decay,
    each unit's ``value`` column is scaled by its bucket weight before
    the merge — weighting subtotals, never stored bytes."""
    cur = read_current(root)
    units = _unit_dirs(root, cur, sel)
    if not units:
        return []
    parts = []
    for d, t1 in units:
        try:
            loaded = LevelArraysSink.load(d)
        except Exception as e:
            raise TornBucketError(f"unreadable level dir {d}: {e!r}")
        w = 1.0
        if decay_half_life is not None and sel.ref is not None:
            w = decay_weight(t1, sel.ref, decay_half_life)
        part = []
        for zoom in sorted(loaded):
            cols = loaded[zoom]
            if w != 1.0:
                cols = dict(cols)
                cols["value"] = np.asarray(cols["value"], np.float64) * w
            part.append(_loaded_to_finalized(cols))
        parts.append(part)
    return drop_zero_rows(merge_level_parts(parts))


def window_variants(keys, window_params) -> list:
    """Window-fold cache-key variants of base tile keys: the serve
    tier keys an undecayed window tile as ``key + ("w", param)`` so
    the ingest loop's targeted invalidation can name exactly the
    entries a new batch or a bucket roll dirties."""
    out = []
    for p in window_params:
        out.extend(tuple(k) + ("w", str(p)) for k in keys)
    return out


def retiring_dirs(root: str, prev_ref: float, new_ref: float,
                  window_units) -> list[str]:
    """Unit dirs whose bucket just LEFT at least one active sliding
    window when the newest edge advanced prev_ref -> new_ref — the
    bucket-roll invalidation set. Only these units' tile keys need
    dropping; everything else in the window cache stays valid."""
    cfg = temporal_config(root)
    if cfg is None or new_ref <= prev_ref:
        return []
    cur = read_current(root)
    bucket_entries, _none = _manifest_units(root, cur)
    live = _live_units(root, cfg)
    base = cur.get("base")
    out = []

    def _retired(t1) -> bool:
        return any(prev_ref - w < t1 <= new_ref - w
                   for w in window_units)

    for b in bucket_entries:
        if _retired(float(b["t1"])):
            out.append(os.path.join(root, base or "", tb.BUCKETS_DIRNAME,
                                    b["name"]))
    for u in live:
        if u["t1"] is not None and _retired(u["t1"]):
            out.append(os.path.join(root, u["artifact"]))
    return [d for d in out if os.path.isdir(d)]
