"""Batch job orchestration: the single-shot ``batchMain`` on one device.

Port of the single-device, single-shot path of
heatmap_tpu/pipeline/batch.py (reference heatmap.py:152-158):

    rows -> dataframe_loader -> build_heatmaps -> heatmap_to_json -> sink

Host-side ingest filtering and vocab building (strings never reach the
device), one f64 projection to detail-zoom Morton codes on the device,
the single-sort composite-key cascade on the device (cascade.py), and
host-side blob egress. Every entry point takes ``device`` ("cuda" by
default; "cpu" runs the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from heatmap_tpu_torch.devices import resolve_device, stage
from heatmap_tpu_torch.pipeline import cascade as cascade_mod
from heatmap_tpu_torch.pipeline.groups import ALL_GROUP, EXCLUDED, UserVocab
from heatmap_tpu_torch.pipeline.timespan import TimespanVocab
from heatmap_tpu_torch.tilemath import mercator, morton

BACKGROUND_SOURCE = "background"  # dropped at ingest, reference heatmap.py:28-29

#: The partitioned kernel's weighted geometry in the JAX package
#: (chunk 1024, one stream): its f32 exactness slab 2^24 // bound must
#: hold one chunk, so the port refuses the same bounds.
_MAX_PARTITIONED_WEIGHT_BOUND = (1 << 24) // 1024


@dataclasses.dataclass(frozen=True)
class BatchJobConfig:
    """Flags replacing the reference's hard-coded constants
    (reference heatmap.py:16-23)."""

    detail_zoom: int = 21
    min_detail_zoom: int = 5
    result_delta: int = 5
    timespans: tuple = ("alltime",)
    # Reference-compat quirks (SURVEY.md §8.1, §8.2), off by default:
    amplify_all: bool = False
    first_timespan_only: bool = False
    capacity: int | None = None
    #: Sum the source's per-point 'value' column instead of counting
    #: (the cascade accumulates in f64; blob values become the sums).
    weighted: bool = False
    #: Cascade reduction backend: "auto" (default), "scatter", or
    #: "partitioned" (the CUDA segment-reduce kernel). "auto" routes
    #: count jobs on a CUDA device to "partitioned" and everything else
    #: to "scatter" (see resolved_cascade_backend).
    cascade_backend: str = "auto"
    #: Bounded-integer weight contract for weighted partitioned jobs:
    #: every 'value' is an integer in [0, weight_bound]; a violation is
    #: detected on the device and surfaces as capacity overflow.
    weight_bound: int | None = None

    def __post_init__(self):
        if self.cascade_backend not in ("auto", "scatter", "partitioned"):
            raise ValueError(
                f"unknown cascade backend {self.cascade_backend!r} "
                "(valid: auto, scatter, partitioned) — rejected at "
                "config time so a typo fails before a multi-hour ingest"
            )
        if (self.weighted and self.cascade_backend == "partitioned"
                and self.weight_bound is None):
            raise ValueError(
                "cascade backend 'partitioned' takes weighted jobs "
                "only under the bounded-integer contract: set "
                "weight_bound (every 'value' an integer in "
                "[0, weight_bound]); fractional weights use the "
                "scatter backend — rejected at config time so the "
                "combination fails before ingest"
            )
        if self.weight_bound is not None:
            if not self.weighted:
                raise ValueError(
                    "weight_bound declares the weighted integer "
                    "contract and needs weighted=True — rejected at "
                    "config time so a silently ignored bound cannot "
                    "ship"
                )
            if self.weight_bound < 1:
                raise ValueError(
                    f"weight_bound must be >= 1, got {self.weight_bound}"
                )
            max_bound = _MAX_PARTITIONED_WEIGHT_BOUND
            if (self.cascade_backend == "partitioned"
                    and self.weight_bound > max_bound):
                raise ValueError(
                    f"weight_bound {self.weight_bound} exceeds the "
                    f"partitioned backend's exactness limit "
                    f"{max_bound} (slab 2^24 // bound must hold one "
                    "1024-element chunk) — use the scatter backend "
                    "for larger weights"
                )

    def resolved_cascade_backend(self, device) -> str:
        """The backend the cascade runs on ``device``: an explicit
        request as given; "auto" gives "partitioned" for count jobs on a
        CUDA device, and "scatter" for weighted jobs (the bounded-integer
        route is an explicit opt-in) and on the CPU."""
        if self.cascade_backend != "auto":
            return self.cascade_backend
        if self.weighted:
            return "scatter"
        return "partitioned" if torch.device(device).type == "cuda" else "scatter"

    def cascade_config(self) -> cascade_mod.CascadeConfig:
        return cascade_mod.CascadeConfig(
            detail_zoom=self.detail_zoom,
            min_detail_zoom=self.min_detail_zoom,
            result_delta=self.result_delta,
            amplify_all=self.amplify_all,
        )


def _row_get(row, key, default=None):
    """Mapping-style ``.get`` for dicts and Row-shaped rows (indexable
    by field name, without ``.get``)."""
    getter = getattr(row, "get", None)
    if getter is not None:
        return getter(key, default)
    try:
        return row[key]
    except (KeyError, ValueError, IndexError, TypeError):
        return default


def load_rows(rows):
    """Ingest filter + column extraction (reference dataframe_loader,
    heatmap.py:25-36): drops ``source == "background"`` rows, keeps
    (latitude, longitude, user_id, timestamp) and, when any row carries
    one, the optional ``value`` weight column (absent values 1.0)."""
    lats, lons, users, stamps, vals = [], [], [], [], []
    _missing = object()
    any_value = False
    for row in rows:
        if _row_get(row, "source") == BACKGROUND_SOURCE:
            continue
        lats.append(row["latitude"])
        lons.append(row["longitude"])
        users.append(row["user_id"])
        stamps.append(_row_get(row, "timestamp"))
        # Keyed on field presence, not non-None values.
        v = _row_get(row, "value", _missing)
        any_value = any_value or v is not _missing
        vals.append(None if v is _missing else v)
    out = {
        "latitude": np.asarray(lats, np.float64),
        "longitude": np.asarray(lons, np.float64),
        "user_id": users,
        "timestamp": stamps,
    }
    if any_value:
        out["value"] = np.asarray(
            [1.0 if v is None else float(v) for v in vals], np.float64
        )
    return out


def load_columns(batch):
    """Vectorized ingest filter over a columnar source batch: drops
    ``source == "background"`` rows (reference heatmap.py:28-29)."""
    src = batch.get("source")
    lat = np.asarray(batch["latitude"], np.float64)
    lon = np.asarray(batch["longitude"], np.float64)
    users = batch["user_id"]
    stamps = batch.get("timestamp")
    values = batch.get("value")
    if values is not None:
        values = np.asarray(values, np.float64)
    if stamps is None or len(stamps) == 0:
        stamps = [None] * len(lat)
    if src is not None and len(src):
        keep = np.asarray(src, object) != BACKGROUND_SOURCE
        if not keep.all():
            idx = np.flatnonzero(keep)
            lat, lon = lat[idx], lon[idx]
            users = [users[i] for i in idx]
            stamps = [stamps[i] for i in idx]
            if values is not None:
                values = values[idx]
    out = {
        "latitude": lat,
        "longitude": lon,
        "user_id": list(users),
        "timestamp": list(stamps),
    }
    if values is not None:
        out["value"] = values
    return out


def ingest_columns(batches, config: BatchJobConfig):
    """Accumulate source batches into the ``_run_loaded`` data dict, or
    None when the batches carried no rows."""
    lats, lons, users, stamps, vals = [], [], [], [], []
    for batch in batches:
        cols = load_columns(batch)
        lats.append(cols["latitude"])
        lons.append(cols["longitude"])
        users.extend(cols["user_id"])
        stamps.extend(cols["timestamp"])
        if config.weighted:
            if "value" not in cols:
                raise ValueError(
                    "weighted job needs a 'value' column in the source "
                    "(CSV/JSONL column named 'value')"
                )
            vals.append(cols["value"])
    if not lats or sum(len(a) for a in lats) == 0:
        return None
    data = {
        "latitude": np.concatenate(lats),
        "longitude": np.concatenate(lons),
        "user_id": users,
        "timestamp": stamps,
    }
    if config.weighted:
        data["value"] = np.concatenate(vals)
    return data


def project_codes(lat, lon, detail_zoom: int, device):
    """f64 projection to detail-zoom Morton codes + validity on
    ``device`` (the numpy arrays are uploaded once)."""
    lat_t = torch.as_tensor(np.asarray(lat, np.float64), device=device)
    lon_t = torch.as_tensor(np.asarray(lon, np.float64), device=device)
    row, col, valid = mercator.project_points(lat_t, lon_t, detail_zoom)
    return morton.morton_encode(row, col, zoom=detail_zoom), valid


def build_emissions(codes, valid, group_ids, timestamps,
                    config: BatchJobConfig, ts_vocab: TimespanVocab | None = None,
                    weights=None):
    """Expand points into (code, slot) emissions + the slot table.

    Mirrors the reference mapper's group expansion (heatmap.py:64-75):
    each point emits once for 'all' and once for its routed group (if
    not excluded), for each requested timespan; with
    ``first_timespan_only`` only the first timespan emits. ``codes``
    and ``valid`` are tensors; the slot ids are assembled on their
    device from int32 uploads of the host vocab columns (``group_ids``
    is numpy). ``weights`` (a tensor, weighted jobs) expand like the
    codes; the returned weights entry is None when not given.

    Returns ``(codes, slots, valid, ts_vocab, n_groups, weights)``.
    """
    ts_vocab = ts_vocab if ts_vocab is not None else TimespanVocab()
    timespans = (
        config.timespans[:1] if config.first_timespan_only else config.timespans
    )
    per_ts_ids = [ts_vocab.label_ids(t, timestamps) for t in timespans]
    n_groups = int(group_ids.max(initial=ALL_GROUP)) + 1
    dev = codes.device
    keep = group_ids != EXCLUDED
    keep_t = torch.as_tensor(keep, device=dev)
    routed_t = torch.as_tensor(
        np.where(keep, group_ids, 0).astype(np.int64), device=dev)
    emit_codes, emit_slots, emit_valid = [], [], []
    for ts_ids in per_ts_ids:
        ts64 = torch.as_tensor(ts_ids.astype(np.int32), device=dev).to(
            torch.int64)
        # 'all' emission for every point.
        emit_codes.append(codes)
        emit_slots.append(ts64 * n_groups + ALL_GROUP)
        emit_valid.append(valid)
        # Per-user emission for non-excluded points.
        emit_codes.append(codes)
        emit_slots.append(ts64 * n_groups + routed_t)
        emit_valid.append(valid & keep_t)
    n_copies = 2 * len(per_ts_ids)
    e_weights = None if weights is None else torch.cat([weights] * n_copies)
    return (
        torch.cat(emit_codes),
        torch.cat(emit_slots),
        torch.cat(emit_valid),
        ts_vocab,
        n_groups,
        e_weights,
    )


def _slot_names(vocab, ts_vocab, n_groups):
    """slot id -> (user name, timespan label) (slot = timespan*G + group)."""
    return {
        t * n_groups + g: (vocab.name_for(g), ts_vocab.label_for(t))
        for t in range(len(ts_vocab))
        for g in range(n_groups)
    }


def run_job(source, sink=None, config: BatchJobConfig | None = None,
            batch_size: int = 1 << 20, device="cuda", timer=None):
    """Source-to-sink job over columnar batches (reference batchMain with
    the row reader and the writer replaced by io sources and sinks).

    Accumulates host columns across source batches, runs the cascade
    once on ``device``, and returns the ``{blob_id: json}`` dict; with a
    ``sink`` it also writes the blobs there (upsert by id). ``timer``
    (a devices.StageTimer) records per-stage milliseconds.
    """
    config = config or BatchJobConfig()
    device = resolve_device(device)
    with stage(timer, "ingest"):
        data = ingest_columns(source.batches(batch_size), config)
    if data is None:
        return {}
    return _run_loaded(data, config, as_json=True, sink=sink, device=device,
                       timer=timer)


def run_batch(rows, config: BatchJobConfig | None = None,
              as_json: bool = False, device="cuda"):
    """The full job: rows in, heatmap blobs out (reference batchMain).

    Returns ``{"user|timespan|coarseTileId": {detailTileId: count}}``,
    or with ``as_json=True`` the inner dicts as JSON strings, matching
    the reference's (id, heatmap-json) records (heatmap.py:156-157).
    """
    config = config or BatchJobConfig()
    device = resolve_device(device)
    data = load_rows(rows)
    if len(data["latitude"]) == 0:
        return {}
    return _run_loaded(data, config, as_json=as_json, device=device)


def _run_loaded(data, config: BatchJobConfig, as_json: bool, sink=None,
                device="cuda", timer=None):
    vocab = UserVocab()
    with stage(timer, "ingest"):
        group_ids = vocab.group_ids(data["user_id"])
    return _run_grouped(
        data["latitude"], data["longitude"], group_ids,
        data["timestamp"], vocab, config, as_json, sink=sink,
        weights=data.get("value") if config.weighted else None,
        device=device, timer=timer,
    )


def _run_grouped(lat, lon, group_ids, timestamps, vocab,
                 config: BatchJobConfig, as_json: bool, sink=None,
                 weights=None, device="cuda", timer=None):
    if config.weighted and weights is None:
        raise ValueError("config.weighted needs per-point weights "
                         "(a 'value' column in the source)")
    device = resolve_device(device)
    with stage(timer, "project"):
        codes, valid = project_codes(lat, lon, config.detail_zoom, device)
    with stage(timer, "emissions"):
        w = (None if not config.weighted else
             torch.as_tensor(np.asarray(weights, np.float64), device=device))
        e_codes, e_slots, e_valid, ts_vocab, n_groups, e_weights = (
            build_emissions(codes, valid, group_ids, timestamps, config,
                            weights=w))
    n_slots = len(ts_vocab) * n_groups
    ccfg = config.cascade_config()
    levels = cascade_mod.run_cascade(
        e_codes, e_slots, ccfg, n_slots=n_slots, valid=e_valid,
        capacity=config.capacity or len(e_codes), weights=e_weights,
        # Weighted sums accumulate in f64; counts use int32.
        acc_dtype=torch.float64 if e_weights is not None else None,
        backend=config.resolved_cascade_backend(device),
        weight_bound=config.weight_bound, timer=timer,
    )
    with stage(timer, "decode"):
        decoded = cascade_mod.decode_levels(levels, ccfg)
    with stage(timer, "egress"):
        finalized = cascade_mod.finalize_level_arrays(
            decoded, ccfg, _slot_names(vocab, ts_vocab, n_groups))
        if as_json:
            blobs = cascade_mod.json_blobs_from_level_arrays(finalized)
        else:
            blobs = cascade_mod.blobs_from_level_arrays(finalized)
        if sink is not None:
            sink.write(blobs.items())
    return blobs
