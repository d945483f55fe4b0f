"""Merging egress artifacts: blob dicts and columnar level shards.

The port's copy of heatmap_tpu/io/merge.py (numpy only). Sharded egress
writes per-host files (``jsonl:...p000``, per-host ``arrays:`` dirs),
so an operator needs an explicit merge to get one artifact; the ``merge``
command runs here. Colliding blob ids SUM their inner dicts (the
linearity every aggregation path relies on), and non-summable
collisions raise instead of resolving last-write-wins. Nothing here
touches a device.
"""

from __future__ import annotations

import json

import numpy as np

from heatmap_tpu_torch.io.sinks import JSONLBlobSink, LevelArraysSink

#: Per-row columns of a finalized level (the write_levels schema).
_LEVEL_ROW_COLS = LevelArraysSink.COLUMNS


def _merge_blob_values(a, b):
    """Sum two blob values that may be JSON strings of {tile: count}.

    Collisions MUST be summable {tile: number} dicts — that is the
    only shape this framework's egress emits, so anything else at a
    merge point is corruption and raises (the loud-overflow
    convention) instead of a silent last-process-wins.
    """
    decode = isinstance(a, str)
    da = json.loads(a) if decode else a
    db = json.loads(b) if isinstance(b, str) else b
    if not (isinstance(da, dict) and isinstance(db, dict)):
        raise ValueError(
            f"colliding blob values are not mergeable dicts "
            f"({type(da).__name__} vs {type(db).__name__})"
        )
    out = dict(da)
    for k, v in db.items():
        if k not in out:  # no collision: shape constraints don't apply
            out[k] = v
            continue
        prev = out[k]
        if not (isinstance(v, (int, float))
                and isinstance(prev, (int, float))):
            raise ValueError(
                f"non-numeric blob collision for detail tile {k!r} "
                f"({type(prev).__name__} + {type(v).__name__})"
            )
        out[k] = prev + v
    return json.dumps(out) if decode else out


def merge_blob_parts(parts) -> dict:
    """Fold per-host blob sub-dicts into one dict, summing collisions
    (the same linearity as gather_blobs, applied to one owner shard)."""
    merged: dict = {}
    for part in parts:
        for key, val in part.items():
            merged[key] = (
                _merge_blob_values(merged[key], val) if key in merged else val
            )
    return merged


def merge_level_parts(parts) -> list:
    """Merge per-source finalized-level subsets into merged levels.

    Re-maps each part's dictionary-encoded user/timespan indices into
    merged (sorted, deduplicated) name tables, concatenates rows, and
    re-aggregates collisions — rows of a blob that straddled host
    ingest shards — by summing ``value`` (counts and weighted sums are
    both linear). Output rows are sorted by (timespan, user, row, col)
    for run-to-run determinism.
    """
    by_zoom: dict[int, list[dict]] = {}
    for part in parts:
        for lvl in part:
            by_zoom.setdefault(int(lvl["zoom"]), []).append(lvl)
    merged_levels = []
    for zoom in sorted(by_zoom, reverse=True):
        subs = by_zoom[zoom]
        user_names = np.unique(np.concatenate(
            [np.asarray(s["user_names"]) for s in subs]
        )) if subs else np.asarray([], dtype="U1")
        ts_names = np.unique(np.concatenate(
            [np.asarray(s["timespan_names"]) for s in subs]
        )) if subs else np.asarray([], dtype="U1")
        cols = {}
        for key in _LEVEL_ROW_COLS:
            if key == "user_idx":
                cols[key] = np.concatenate([
                    np.searchsorted(
                        user_names, np.asarray(s["user_names"])
                    )[np.asarray(s["user_idx"])].astype(np.int32)
                    if len(s["user_idx"]) else
                    np.asarray([], np.int32)
                    for s in subs
                ])
            elif key == "timespan_idx":
                cols[key] = np.concatenate([
                    np.searchsorted(
                        ts_names, np.asarray(s["timespan_names"])
                    )[np.asarray(s["timespan_idx"])].astype(np.int32)
                    if len(s["timespan_idx"]) else
                    np.asarray([], np.int32)
                    for s in subs
                ])
            else:
                cols[key] = np.concatenate(
                    [np.asarray(s[key]) for s in subs]
                )
        order = np.lexsort(
            (cols["col"], cols["row"], cols["user_idx"], cols["timespan_idx"])
        )
        for key in _LEVEL_ROW_COLS:
            cols[key] = cols[key][order]
        n = len(cols["row"])
        if n:
            same = np.zeros(n, bool)
            same[1:] = (
                (cols["timespan_idx"][1:] == cols["timespan_idx"][:-1])
                & (cols["user_idx"][1:] == cols["user_idx"][:-1])
                & (cols["row"][1:] == cols["row"][:-1])
                & (cols["col"][1:] == cols["col"][:-1])
            )
            starts = np.flatnonzero(~same)
            sums = np.add.reduceat(cols["value"], starts)
            for key in _LEVEL_ROW_COLS:
                cols[key] = cols[key][starts]
            cols["value"] = sums
        lvl = dict(cols)
        lvl["zoom"] = zoom
        lvl["coarse_zoom"] = int(subs[0]["coarse_zoom"])
        lvl["user_names"] = user_names
        lvl["timespan_names"] = ts_names
        merged_levels.append(lvl)
    return merged_levels


def merge_blob_files(paths) -> dict:
    """Merge JSONL blob files -> {blob_id: decoded dict}.

    Disjoint ids union; colliding ids sum per detail tile (a blob
    whose detail tiles straddled host shards, or the same job run
    twice — sums are what Cassandra upsert-with-reaggregation would
    have produced). Non-numeric collisions raise.
    """
    return merge_blob_parts(JSONLBlobSink.load(p) for p in paths)


def _loaded_to_finalized(cols) -> dict:
    """A LevelArraysSink.load level (materialized string user/timespan
    columns) -> the finalized write_levels format (dictionary-encoded
    indices + name tables) merge_level_parts consumes."""
    user_names, u_idx = np.unique(
        np.asarray(cols["user"], str), return_inverse=True
    )
    ts_names, t_idx = np.unique(
        np.asarray(cols["timespan"], str), return_inverse=True
    )
    return {
        "zoom": int(cols["zoom"]),
        "coarse_zoom": int(cols["coarse_zoom"]),
        "row": np.asarray(cols["row"]),
        "col": np.asarray(cols["col"]),
        "value": np.asarray(cols["value"]),
        "user_idx": u_idx.astype(np.int32),
        "timespan_idx": t_idx.astype(np.int32),
        "user_names": user_names,
        "timespan_names": ts_names,
        "coarse_row": np.asarray(cols["coarse_row"]),
        "coarse_col": np.asarray(cols["coarse_col"]),
    }


def merge_level_dirs(dirs) -> list:
    """Merge LevelArraysSink dirs -> finalized level dicts
    (write_levels input format), re-aggregated by
    (timespan, user, row, col) with values summed — the same core as
    the cross-host columnar merge (merge_level_parts).

    Zoom sets union across shards; shards disagreeing on a level's
    coarse_zoom are not shards of one job and raise.
    """
    loaded = [LevelArraysSink.load(d) for d in dirs]
    zooms = sorted(set().union(*(set(l) for l in loaded)))
    for zoom in zooms:
        coarse = {int(l[zoom]["coarse_zoom"]) for l in loaded if zoom in l}
        if len(coarse) != 1:
            raise ValueError(
                f"level z{zoom}: shards disagree on coarse_zoom "
                f"({sorted(coarse)}) — these dirs are not shards of "
                "one job"
            )
    parts = [
        [_loaded_to_finalized(levels[zoom]) for zoom in sorted(levels)]
        for levels in loaded
    ]
    return merge_level_parts(parts)
