"""Bucket ladder, naming, and the TEMPORAL.json base manifest.

The port's copy of heatmap_tpu/temporal/buckets.py (stdlib only).

A temporal store partitions journaled history by batch watermark into
time buckets on a geometric ladder (the telemetry store's 10s/1m/10m
tier shape): tier-0 buckets are ``width`` wide, tier-j buckets are
``width * fanout**j`` wide, and each tier keeps the newest ``keep``
intervals before coarsening into the next tier. All tier widths are
integer multiples of ``width`` aligned to 0, so intervals nest exactly
and a bucket never straddles its coarsening target.

The bucket config is BYTE-AFFECTING for temporal folds (which buckets
exist determines which cuts are expressible), so it is pinned in the
store's CURRENT pointer like the cascade config fingerprint
(delta/compact.py check_config) — first writer sets it, later writers
must match.

Bucket membership is *batch-granular*: a journal entry belongs to the
tier-0 bucket containing its watermark (the batch's max timestamp).
Entries with no timestamps land in the timeless ``bucket-none``, which
every fold includes with weight 1.0. Base dirs carry their buckets
under ``buckets/bucket-<t0>-<t1>/`` (plain LevelArraysSink level dirs)
plus one ``TEMPORAL.json`` manifest listing {name, t0, t1, tier,
epochs, points, digest} per bucket — staged in the compaction tmp dir,
so the manifest and buckets publish atomically with the base.
"""

from __future__ import annotations

import hashlib
import json
import os

TEMPORAL_SCHEMA = "heatmap-tpu.temporal.v1"
MANIFEST_NAME = "TEMPORAL.json"
BUCKETS_DIRNAME = "buckets"
#: The timeless bucket: journal entries whose batches carry no
#: timestamps. Included in every fold (all-time, as_of, window) with
#: decay weight 1.0 — rows with no time axis never age.
NONE_NAME = "bucket-none"

#: Named sliding windows accepted by ``?window=`` (seconds).
WINDOW_SECONDS = {"1h": 3600.0, "1d": 86400.0, "1w": 604800.0}

#: Keys of a temporal config (all byte-affecting for folds).
CONFIG_KEYS = ("width", "fanout", "keep", "tiers", "unit_s")

_DEFAULTS = {"width": 3600.0, "fanout": 4, "keep": 8, "tiers": 4,
             "unit_s": 1.0}


def normalize_config(cfg: dict | None = None, **overrides) -> dict:
    """Validated, canonical temporal config dict (json-able).

    ``width`` is in watermark units; ``unit_s`` converts named windows
    ("1h"/"1d"/"1w", defined in seconds) into watermark units for data
    whose timestamps are not seconds (ms feeds use unit_s=1000).
    """
    out = dict(_DEFAULTS)
    for src in (cfg or {}), overrides:
        for k, v in src.items():
            if v is None:
                continue
            if k not in _DEFAULTS:
                raise ValueError(f"unknown temporal config key {k!r}")
            out[k] = v
    out["width"] = float(out["width"])
    out["fanout"] = int(out["fanout"])
    out["keep"] = int(out["keep"])
    out["tiers"] = int(out["tiers"])
    out["unit_s"] = float(out["unit_s"])
    if out["width"] <= 0:
        raise ValueError("temporal width must be > 0")
    if out["fanout"] < 2:
        raise ValueError("temporal fanout must be >= 2")
    if out["keep"] < 1 or out["tiers"] < 1:
        raise ValueError("temporal keep and tiers must be >= 1")
    if out["unit_s"] <= 0:
        raise ValueError("temporal unit_s must be > 0")
    return out


def parse_window(text, cfg: dict) -> float:
    """``?window=`` value -> width in watermark units. Accepts the
    named windows (seconds scaled by unit_s) or a bare number already
    in watermark units."""
    if text in WINDOW_SECONDS:
        return WINDOW_SECONDS[text] * float(cfg.get("unit_s", 1.0))
    try:
        w = float(text)
    except (TypeError, ValueError):
        raise ValueError(
            f"window must be one of {sorted(WINDOW_SECONDS)} or a "
            f"number of watermark units, got {text!r}")
    if w <= 0:
        raise ValueError(f"window must be > 0, got {w}")
    return w


def tier_width(cfg: dict, tier: int) -> float:
    return float(cfg["width"]) * int(cfg["fanout"]) ** int(tier)


def bucket_of(watermark: float, cfg: dict, tier: int = 0):
    """(t0, t1) of the tier-aligned bucket containing ``watermark``."""
    w = tier_width(cfg, tier)
    import math

    t0 = math.floor(float(watermark) / w) * w
    return t0, t0 + w


def _fmt_edge(t: float) -> str:
    f = float(t)
    return str(int(f)) if f.is_integer() else repr(f)


def bucket_name(t0: float, t1: float) -> str:
    return f"bucket-{_fmt_edge(t0)}-{_fmt_edge(t1)}"


def age_tier(t1: float, cfg: dict, max_edge: float) -> int:
    """Target tier for a bucket ending at ``t1`` when the newest edge
    is ``max_edge``: each tier j spans ``keep`` intervals of width
    ``width * fanout**j`` before history coarsens into tier j+1; the
    top tier is unbounded."""
    age = float(max_edge) - float(t1)
    cum = 0.0
    for j in range(int(cfg["tiers"])):
        cum += int(cfg["keep"]) * tier_width(cfg, j)
        if age < cum:
            return j
    return int(cfg["tiers"]) - 1


def plan_partition(units: list[dict], cfg: dict, max_edge: float) -> dict:
    """Deterministic bucket partition for a compaction pass.

    ``units`` are the mergeable inputs — existing buckets from the
    previous base ({"t0","t1","tier", ...}) and tier-0 groups of new
    live deltas — and the result maps target ``(t0, t1, tier)`` ->
    list of member units. Each unit's target tier is the max of its own
    tier (a coarse bucket never splits back) and its age tier; nested
    target intervals then escalate into their containing interval, so
    the final intervals are disjoint. Pure function of (units, cfg,
    max_edge) — two compactions over the same history agree.
    """
    tagged = []
    for u in units:
        j = max(int(u.get("tier", 0)), age_tier(u["t1"], cfg, max_edge))
        t0, _ = bucket_of(u["t0"], cfg, tier=j)
        tagged.append([j, t0, t0 + tier_width(cfg, j), u])
    # Escalate intervals nested inside a coarser sibling's interval
    # until disjoint (at most ``tiers`` rounds — tiers is small).
    for _ in range(int(cfg["tiers"]) + 1):
        changed = False
        spans = {(j, t0, t1) for j, t0, t1, _ in tagged}
        for rec in tagged:
            j, t0, t1, u = rec
            for sj, s0, s1 in spans:
                if sj > j and s0 <= t0 and t1 <= s1:
                    nt0, _ = bucket_of(t0, cfg, tier=sj)
                    rec[0], rec[1], rec[2] = sj, nt0, nt0 + tier_width(
                        cfg, sj)
                    changed = True
                    break
        if not changed:
            break
    groups: dict = {}
    for j, t0, t1, u in tagged:
        groups.setdefault((t0, t1, j), []).append(u)
    return groups


def bucket_digest(bucket_dir: str) -> str:
    """Integrity digest over every file in a bucket dir (sorted by
    name) — same discipline as the journal's entry_digest, verified by
    the recovery sweep so a torn bucket quarantines instead of folding
    garbage into a temporal view."""
    h = hashlib.sha256()
    if os.path.isdir(bucket_dir):
        for name in sorted(os.listdir(bucket_dir)):
            full = os.path.join(bucket_dir, name)
            if not os.path.isfile(full):
                continue
            h.update(name.encode())
            with open(full, "rb") as f:
                h.update(f.read())
    return "sha256:" + h.hexdigest()


def write_manifest(base_dir: str, manifest: dict):
    """Write TEMPORAL.json into ``base_dir``. Callers stage this
    inside the compaction tmp dir before publish_dir, so the manifest
    rides the base's own atomic publish — no separate flip needed."""
    path = os.path.join(base_dir, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")


def read_manifest(base_dir: str) -> dict | None:
    """The base's temporal manifest, or None when the base predates
    the temporal plane (or the manifest was quarantined)."""
    try:
        with open(os.path.join(base_dir, MANIFEST_NAME)) as f:
            m = json.load(f)
    except (FileNotFoundError, NotADirectoryError, ValueError, OSError):
        return None
    if m.get("schema") != TEMPORAL_SCHEMA:
        return None
    return m
