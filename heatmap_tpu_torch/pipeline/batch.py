"""Batch job orchestration: the reference ``batchMain`` on one device.

Port of the single-device paths of heatmap_tpu/pipeline/batch.py
(reference heatmap.py:152-158):

    rows -> dataframe_loader -> build_heatmaps -> heatmap_to_json -> sink

Host-side ingest filtering and vocab building (strings never reach the
device), one f64 projection to detail-zoom Morton codes on the device,
the single-sort composite-key cascade on the device (cascade.py), and
host-side blob egress. The entry points:

- ``run_job``: any columnar source, single-shot; or, for sources that
  would not fit host RAM (or with ``max_points_in_flight``), chunked,
  with a host-side merge of each level across chunks, optionally spilled
  to disk, and the next chunk fed to the device while the current one
  runs (pipeline/feeder.py);
- ``run_job_fast``: the integer fast path for CSV files (native
  decoder) and HMPB files (memory map), single-shot, chunked, or with
  checkpoint/resume;
- ``run_job_resumable``: ``run_job`` with checkpoint/resume over source
  batches;
- ``run_batch``: rows in, blobs out.

Every entry point takes ``device`` ("cuda" by default; "cpu" runs the
plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings

import numpy as np
import torch

from heatmap_tpu_torch import native, obs
from heatmap_tpu_torch.devices import resolve_device, stage
from heatmap_tpu_torch.pipeline import bucketing as bucketing_mod
from heatmap_tpu_torch.pipeline import cascade as cascade_mod
from heatmap_tpu_torch.pipeline import feeder as feeder_mod
from heatmap_tpu_torch.pipeline.groups import ALL_GROUP, EXCLUDED, UserVocab
from heatmap_tpu_torch.pipeline.timespan import TS_MISSING, TimespanVocab
from heatmap_tpu_torch.tilemath import mercator, morton
from heatmap_tpu_torch.utils.checkpoint import CheckpointManager
from heatmap_tpu_torch.utils.trace import (get_tracer, stage_block,
                                           stage_span,
                                           stage_tracing_enabled)

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
    #: Shrink cascade levels 1.. to the real unique counts (one host
    #: sync per level; identical blobs; ops.pyramid.adaptive_keep). On
    #: the partitioned backend it cuts each level's output capacity.
    adaptive_capacity: bool = False
    #: Bucketed padding (pipeline/bucketing.py): "exact" (default;
    #: shapes follow the input), "pow2" or "geometric" (pad emissions up
    #: to a power-of-two / 1.25x-geometric bucket with masked pad lanes,
    #: the JAX package's compile-cache knob). Byte-neutral: decode
    #: truncates to the real unique counts. Runtime tuning, not data
    #: semantics: delta/compact.CONFIG_FIELDS leaves it out, so stores
    #: accept mixed settings.
    pad_bucketing: str = "exact"
    #: Bucket floor for pad_bucketing != "exact": batches below this
    #: many emissions pad up to it (bucketing.bucket_size).
    pad_bucket_min: int = 1 << 12
    #: Data-parallelize the cascade over the process's local devices
    #: (parallel.mesh.local_devices). None (default) engages the mesh
    #: past one local device and AUTO_DP_MIN_EMISSIONS emissions; True
    #: forces it at any size and device count (one H100: a 1-shard
    #: mesh); False pins the single-device cascade. Counts and integer
    #: weighted sums are bit-identical either way; fractional weighted
    #: sums agree to float64 summation order.
    data_parallel: bool | None = None
    #: Cross-shard merge of the data-parallel cascade: "replicated"
    #: (all-gather the compact partials, merge and roll up once) or
    #: "prefix" (coarse-prefix all-to-all regroup, each shard merges
    #: its key range). Blobs identical either way. Ignored off the mesh.
    dp_merge: str = "replicated"
    #: Auto-DP engagement threshold override (emissions at which
    #: ``data_parallel=None`` engages the mesh); None uses
    #: AUTO_DP_MIN_EMISSIONS. Auto mode only.
    dp_min_emissions: int | None = None
    #: Morton-range sharding of the data-parallel cascade
    #: (parallel/partition.py): "auto" (when the mesh engages and the
    #: emissions reach the auto-DP threshold), "morton" (whenever a mesh
    #: engages) or "off" (uniform DP). Byte-neutral; a degenerate plan
    #: falls back to uniform DP with a backend_resolved event.
    spatial_partition: str = "auto"
    #: Mesh-cascade formulation: "auto" ("gspmd" except with
    #: dp_merge="prefix"), "gspmd" (parallel/gspmd.py: on-device
    #: routing, stacked-shard rollup) or "shard_map" (parallel/
    #: sharded.py with host-side range routing). Byte-identical outputs.
    #: Only "gspmd" composes with adaptive_capacity.
    dispatch: str = "auto"

    def __post_init__(self):
        if self.pad_bucketing not in bucketing_mod.BUCKETING_MODES:
            raise ValueError(
                f"unknown pad_bucketing {self.pad_bucketing!r} (valid: "
                f"{', '.join(bucketing_mod.BUCKETING_MODES)}) — rejected "
                "at config time so a typo fails before a multi-hour ingest"
            )
        if self.pad_bucket_min < 1:
            raise ValueError(
                f"pad_bucket_min must be >= 1, got {self.pad_bucket_min}"
            )
        if self.dp_merge not in ("replicated", "prefix"):
            raise ValueError(
                f"unknown dp_merge {self.dp_merge!r} (valid: "
                "replicated, prefix) — rejected at config time so a "
                "typo fails before a multi-hour ingest"
            )
        if self.dp_min_emissions is not None:
            if self.data_parallel is not None:
                raise ValueError(
                    "dp_min_emissions tunes AUTO data-parallel routing "
                    "only; data_parallel=True/False ignore the "
                    "threshold — rejected at config time so a "
                    "calibration flag that silently does nothing "
                    "cannot ship"
                )
            if self.dp_min_emissions < 0:
                raise ValueError(
                    f"dp_min_emissions must be >= 0, got "
                    f"{self.dp_min_emissions}"
                )
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
        if self.dispatch not in ("auto", "gspmd", "shard_map"):
            raise ValueError(
                f"unknown dispatch {self.dispatch!r} (valid: auto, "
                "gspmd, shard_map) — rejected at config time so a typo "
                "fails before a multi-hour ingest"
            )
        if self.dispatch == "gspmd" and self.dp_merge == "prefix":
            raise ValueError(
                "dispatch='gspmd' has no prefix-merge program yet; "
                "dp_merge='prefix' needs dispatch='shard_map' (or "
                "'auto', which resolves it there)"
            )
        if (self.data_parallel and self.adaptive_capacity
                and self.resolved_dispatch != "gspmd"):
            raise ValueError(
                "the shard_map mesh cascade is shape-static; "
                "adaptive_capacity reads concrete per-level counts "
                "and does not compose — disable one of them, or use "
                "dispatch='gspmd' (its global-view rollup accepts "
                "adaptive shrinking)"
            )
        if self.spatial_partition not in ("auto", "morton", "off"):
            raise ValueError(
                f"unknown spatial_partition {self.spatial_partition!r} "
                "(valid: auto, morton, off) — rejected at config time "
                "so a typo fails before a multi-hour ingest"
            )
        if self.spatial_partition == "morton":
            if self.data_parallel is False:
                raise ValueError(
                    "spatial_partition='morton' range-shards the "
                    "data-parallel cascade; data_parallel=False pins "
                    "the single-device path — rejected at config time "
                    "so a silently ignored partition cannot ship"
                )
            if (self.adaptive_capacity
                    and self.resolved_dispatch != "gspmd"):
                raise ValueError(
                    "spatial_partition='morton' with "
                    "dispatch='shard_map' rides the host-routed "
                    "shape-static mesh path; adaptive_capacity does "
                    "not compose there — use dispatch='gspmd' (or "
                    "'auto'), whose on-device routing accepts it"
                )

    @property
    def resolved_dispatch(self) -> str:
        """The mesh formulation the cascade runs: "auto" resolves to
        gspmd except with dp_merge="prefix", which keeps the shard_map
        prefix kernel."""
        if self.dispatch != "auto":
            return self.dispatch
        return "shard_map" if self.dp_merge == "prefix" else "gspmd"

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


def kept_rows(batch):
    """Indices of the rows the ingest filter keeps (``source`` is not
    "background", reference heatmap.py:28-29), or None for all rows."""
    src = batch.get("source")
    if src is None or not len(src):
        return None
    keep = np.asarray(src, object) != BACKGROUND_SOURCE
    return None if keep.all() else np.flatnonzero(keep)


def load_columns(batch):
    """Vectorized ingest filter over a columnar source batch: drops
    ``source == "background"`` rows (reference heatmap.py:28-29)."""
    lat = np.asarray(batch["latitude"], np.float64)
    lon = np.asarray(batch["longitude"], np.float64)
    users = batch["user_id"]
    stamps = batch.get("timestamp")
    values = batch.get("value")
    if values is not None:
        values = np.asarray(values, np.float64)
    if stamps is None or len(stamps) == 0:
        stamps = [None] * len(lat)
    idx = kept_rows(batch)
    if idx is not None:
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
    tracer = get_tracer()
    ing = _Ingest(config)
    for batch in batches:
        with tracer.span("ingest.batch"):
            m = ing.append(ing.read(batch))
        tracer.add_items("ingest.batch", m)
    if not len(ing):
        return None
    with stage_span("ingest.concat"):
        lat, lon, users, stamps, values = ing.take()
        data = {"latitude": lat, "longitude": lon, "user_id": users,
                "timestamp": stamps}
        if config.weighted:
            data["value"] = values
    return data


def project_detail_codes(lat, lon, detail_zoom: int,
                         prefer_device: bool = True, device="cuda"):
    """f64 projection to detail-zoom Morton codes + validity, as numpy
    arrays (int64 codes, bool mask).

    With ``prefer_device`` the projection and interleave run on
    ``device`` (:func:`project_codes`; the rows near an edge re-derived
    on the host, so the codes are the reference's); without it on the
    host in numpy (``mercator.project_points_np``), as the JAX
    package's ``prefer_device=False`` does.
    """
    if prefer_device:
        codes, valid = project_codes(lat, lon, detail_zoom,
                                     resolve_device(device))
        return codes.cpu().numpy(), valid.cpu().numpy()
    row, col, valid = mercator.project_points_np(lat, lon, detail_zoom)
    return morton.morton_encode_np(row, col), valid


def project_codes(lat, lon, detail_zoom: int, device):
    """f64 projection to detail-zoom Morton codes + validity on
    ``device`` (numpy arrays are uploaded once; float64 tensors already
    there are used as they are)."""
    lat_t = torch.as_tensor(lat, dtype=torch.float64, device=device)
    lon_t = torch.as_tensor(lon, dtype=torch.float64, device=device)
    row, col, valid = mercator.project_points(lat_t, lon_t, detail_zoom)
    return morton.morton_encode(row, col, dtype=torch.int64,
                                zoom=detail_zoom), valid


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
    with stage_span("emissions.timespans",
                    items=int(codes.shape[0]) * len(timespans)):
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
    with stage_span("egress.slot_names", items=len(ts_vocab) * n_groups):
        return {
            t * n_groups + g: (vocab.name_for(g), ts_vocab.label_for(t))
            for t in range(len(ts_vocab))
            for g in range(n_groups)
        }


def run_job(source, sink=None, config: BatchJobConfig | None = None,
            batch_size: int = 1 << 20,
            max_points_in_flight: int | None = None,
            overlap_ingest: bool = True,
            merge_spill_dir: str | None = None,
            device="cuda", timer=None,
            feeder_stats: feeder_mod.FeederStats | None = None,
            device_columns: dict | None = None):
    """Source-to-sink job over columnar batches (reference batchMain with
    the row reader and the writer replaced by io sources and sinks).

    Single-shot: accumulates host columns across source batches, runs
    the cascade once on ``device``, and returns the ``{blob_id: json}``
    dict; with a ``sink`` it also writes there (upsert by id; a columnar
    sink such as ``LevelArraysSink`` gets the level arrays and the call
    returns ``{"egress": "levels", "levels": n, "rows": n}``).

    ``max_points_in_flight`` bounds peak memory: the cascade runs per
    chunk of at most that many points and each level's aggregates merge
    on the host, which is exact because every level is a linear
    (key, sum) reduction (counts and integer-valued weights are
    bit-identical to single-shot; fractional weighted sums agree up to
    f64 summation order). ``None`` (default) auto-routes: a source whose
    estimated host columns would not fit half of MemAvailable takes the
    chunked path with a RAM-derived chunk (``_auto_points_in_flight``);
    ``0`` forces single-shot. ``overlap_ingest`` builds and feeds chunk
    N+1 on a worker thread while chunk N runs (pipeline/feeder.py; at
    most 3 chunks resident; pass ``feeder_stats`` to read its numbers).
    ``merge_spill_dir`` spills the per-chunk aggregates to disk and
    merges one level at a time at egress (``_SpillMerge``).

    ``timer`` (a devices.StageTimer) records per-stage milliseconds,
    fenced by device synchronisation.

    ``device_columns`` holds numeric columns already on ``device`` (the
    ingest loop's feeder, pipeline/feeder.py ``CudaColumns``):
    ``latitude``, ``longitude`` and ``value`` tensors of the rows the
    ingest filter keeps, in source order. The cascade reads them in place
    of the host columns, with no second host-to-device copy; everything
    host-side (vocabularies, timespans) still comes from the source. Such
    a job runs single-shot.
    """
    config = config or BatchJobConfig()
    device = resolve_device(device)
    if device_columns is not None:
        if max_points_in_flight:
            raise ValueError("device_columns ride the single-shot path; "
                             "they cannot combine with "
                             "max_points_in_flight")
        max_points_in_flight = 0
    if max_points_in_flight is None:
        max_points_in_flight = _auto_points_in_flight(source)
    if merge_spill_dir is not None and not max_points_in_flight:
        raise ValueError(
            "merge_spill_dir lives on the bounded path, but this job "
            "routed single-shot (source fits host RAM, is unsizeable, "
            "or bounding was disabled with 0); pass "
            "max_points_in_flight > 0 to chunk — silently ignoring the "
            "spill request would run the in-RAM merge it exists to avoid"
        )
    # Tree-only span (no aggregate entry): a bare run_job call under
    # tracing yields one connected tree whose ingest, cascade and egress
    # spans all parent here.
    with obs.tracing.span("run_job", bounded=bool(max_points_in_flight)):
        if max_points_in_flight:  # 0/None -> single-shot
            return _run_job_bounded(
                source, sink, config, batch_size, max_points_in_flight,
                overlap_ingest=overlap_ingest, spill_dir=merge_spill_dir,
                device=device, timer=timer, feeder_stats=feeder_stats,
            )
        with stage(timer, "ingest"):
            data = ingest_columns(source.batches(batch_size), config)
        if data is None:
            return {}
        if device_columns is not None:
            data = _with_device_columns(data, device_columns, device)
        with get_tracer().span("cascade", items=len(data["latitude"])):
            return _run_loaded(data, config, as_json=True, sink=sink,
                               device=device, timer=timer)


def _with_device_columns(data, device_columns, device):
    """``data`` with its numeric host columns swapped for the fed
    tensors of the same rows (checked by length and device)."""
    out = dict(data)
    n = len(data["latitude"])
    for name, t in device_columns.items():
        if name not in data:
            continue
        if t.device.type != device.type or int(t.shape[0]) != n:
            raise ValueError(
                f"fed column {name!r} ({int(t.shape[0])} rows on "
                f"{t.device}) does not match the batch ({n} rows on "
                f"{device})")
        out[name] = t
    return out


#: Rough host bytes per point on the string ingest path: two f64 coords
#: (16) + a user-id share (~60) + a timestamp list slot (~40) +
#: concatenate/emission slack. Deliberately conservative: the cost of
#: underestimating is an OOM, of overestimating a smaller chunk.
_HOST_BYTES_PER_POINT = 160

#: Text-source row-size floor (bytes) for estimating points from file
#: size: a minimal "lat,lon,user" CSV row. Underestimating bytes/row
#: overestimates points, which errs toward bounding, the safe side.
_MIN_TEXT_ROW_BYTES = 32

#: Bounded path: convert the in-RAM cross-chunk merge table to the
#: disk-spill merge once it exceeds this many aggregate rows (~200 MB
#: of columns; the spilled runs are 24 B/row in the system temp dir).
#: Past this size the iterative fold's per-chunk re-scan of the whole
#: table loses to one egress-time sort per level. Small-output jobs
#: never cross it and never touch disk.
AUTO_SPILL_ROWS = 8_000_000

#: Directory for automatic spill (None -> tempfile.gettempdir(), which
#: follows TMPDIR).
AUTO_SPILL_DIR: str | None = None


def _mount_fstype(path: str, mounts_file: str = "/proc/mounts") -> str | None:
    """Filesystem type of the longest mount-point prefix of ``path``
    (Linux), or None when undeterminable."""
    try:
        real = os.path.realpath(path)
        best, fstype = "", None
        with open(mounts_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt, typ = parts[1], parts[2]
                if real == mnt or real.startswith(mnt.rstrip("/") + "/") \
                        or mnt == "/":
                    if len(mnt) > len(best):
                        best, fstype = mnt, typ
        return fstype
    except OSError:
        return None


def _free_disk_bytes(path: str) -> int | None:
    """Free bytes available to this process on ``path``'s filesystem,
    or None when unknowable."""
    try:
        st = os.statvfs(path)
        return st.f_bavail * st.f_frsize
    except (OSError, AttributeError):
        return None


def _auto_spill_projection_fits(spill_dir: str, table_rows: int,
                                chunks_done: int,
                                total_chunks_est: int | None,
                                max_chunk_rows: int) -> bool:
    """Will the projected spill volume fit the target filesystem?

    Auto-spill must never turn a job that was finishing fine in RAM into
    an ENOSPC failure. Projection: the accumulated table spills at once
    (24 B/row) and each remaining chunk adds at most the largest chunk's
    output so far; when the source size is unknowable, assume as many
    chunks remain as have run. 25% headroom.
    """
    free = _free_disk_bytes(spill_dir)
    if free is None:
        return True
    remaining = (chunks_done if total_chunks_est is None
                 else max(total_chunks_est - chunks_done, 0))
    projected = 24 * (table_rows + remaining * max_chunk_rows)
    return projected + projected // 4 <= free


def _auto_spill_target() -> str | None:
    """Directory for automatic spill, or None to stay in RAM.

    RAM-backed candidates (tmpfs/ramfs) are refused: spilling there
    moves pages from process RSS into tmpfs, which the OOM killer
    counts all the same. An explicit ``merge_spill_dir`` is never
    second-guessed.
    """
    import tempfile

    cand = AUTO_SPILL_DIR or tempfile.gettempdir()
    if _mount_fstype(cand) in ("tmpfs", "ramfs"):
        return None
    return cand


def _available_ram_bytes() -> int | None:
    """MemAvailable from /proc/meminfo (Linux), else total RAM via
    sysconf, else None (no auto-routing without a signal)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return None


def _estimate_source_points(source) -> int | None:
    """Best-effort source row count: a declared ``n`` (synthetic, HMPB)
    beats a file-size estimate (text sources); None when unknowable."""
    n = getattr(source, "n", None)
    if n is not None:
        return int(n)
    path = source if isinstance(source, str) else getattr(source, "path", None)
    if isinstance(path, str):
        try:
            if os.path.isdir(path):
                size = sum(
                    e.stat().st_size for e in os.scandir(path) if e.is_file()
                )
            else:
                size = os.path.getsize(path)
        except OSError:
            return None
        return size // _MIN_TEXT_ROW_BYTES
    return None


def _auto_points_in_flight(source, ram_budget: int | None = None,
                           shard_count: int = 1,
                           fast: bool = False,
                           n_timespans: int = 1,
                           weighted: bool = False) -> int | None:
    """Bounded-path chunk size when the source won't fit RAM, else None.

    Half of MemAvailable is the working budget; a source whose
    estimated host columns exceed it routes to the bounded path with a
    chunk of a quarter of what fits (cascade state + double-buffered
    ingest + merge state share the budget). Sources that fit keep the
    faster single-shot path.

    ``shard_count`` divides the estimate among processes sharing the
    source. ``fast`` (run_job_fast's auto call) consults the source's
    ``fast_host_bytes_per_point`` (HMPB mmap ingest is near-zero-copy),
    plus the emission arrays per timespan (and, ``weighted``, the value
    column and its emission copies), which share the same budget.
    """
    est = _estimate_source_points(source)
    if est is None:
        return None
    est = -(-est // max(shard_count, 1))
    if ram_budget is None:
        avail = _available_ram_bytes()
        if avail is None:
            return None
        ram_budget = avail // 2
    bytes_per_point = _HOST_BYTES_PER_POINT
    if fast:
        declared = getattr(source, "fast_host_bytes_per_point", None)
        if declared is not None:
            # i64 code + i64 slot + valid, ~2x transiently under the
            # cascade sort, 2 emissions per timespan per point.
            bytes_per_point = declared + 64 * max(n_timespans, 1)
            if weighted:
                bytes_per_point += 8 + 32 * max(n_timespans, 1)
    fits = ram_budget // bytes_per_point
    if est <= fits:
        return None
    # A quarter of what fits, floored at 64k points; the floor must stay
    # well under the budget or auto-bounding would itself overrun it.
    return max(1 << 16, fits // 4)


class _FastRouter:
    """Maps fast-batch reader group ids into a shared UserVocab.

    Fast batches carry ``routed`` ids into a reader-side ``names`` table
    that grows via ``new_group_names``; vocab ids are assigned in
    first-use order of kept rows, so they match the string path's
    assignment order exactly (run_job_fast and the fast bounded path
    share this logic).
    """

    def __init__(self, vocab: UserVocab):
        self.vocab = vocab
        self.names: list = []
        self._map = np.full(1024, -2, np.int32)  # -2 = not yet mapped

    def observe(self, batch):
        """Grow the reader name table (required for every batch, even
        ones whose rows are skipped: later batches reference ids first
        named earlier)."""
        self.names.extend(batch["new_group_names"])

    def route(self, batch):
        """-> (lat, lon, gids, ts_i64, values_or_None), background rows
        dropped; ``values`` when the fast batch carries a 'value'
        column, filtered by the same mask."""
        if len(self.names) > len(self._map):
            grown = np.full(max(len(self.names), 2 * len(self._map)),
                            -2, np.int32)
            grown[: len(self._map)] = self._map
            self._map = grown
        keep = ~batch["background"]
        routed = batch["routed"][keep]
        ref_ids = routed[routed >= 0]
        unmapped = self._map[ref_ids] == -2
        if unmapped.any():
            first_use = ref_ids[unmapped]
            _, order = np.unique(first_use, return_index=True)
            for rid in first_use[np.sort(order)]:
                if self._map[rid] == -2:
                    self._map[rid] = self.vocab.id_for(self.names[rid])
        gids = np.where(
            routed >= 0, self._map[np.maximum(routed, 0)], EXCLUDED
        ).astype(np.int32)
        ts = batch.get("timestamp")
        ts64 = (
            np.full(int(keep.sum()), TS_MISSING, np.int64)
            if ts is None else np.asarray(ts, np.int64)[keep]
        )
        vals = batch.get("value")
        if vals is not None:
            vals = np.asarray(vals, np.float64)[keep]
        return (batch["latitude"][keep], batch["longitude"][keep], gids,
                ts64, vals)


def _stamps_to_checkpoint(flat_stamps) -> dict:
    """The timestamp arrays of a string-path checkpoint: none when every
    stamp is None; an i64 epoch-ms column (TS_MISSING for None) when the
    stamps are numbers or datetimes/dates; their strings plus a validity
    mask otherwise. Resumed runs then bucket dated timespans exactly as
    an uninterrupted run."""
    if not flat_stamps or all(s is None for s in flat_stamps):
        return {}
    import datetime as _dt

    valid = np.asarray([s is not None for s in flat_stamps], bool)
    present = [s for s in flat_stamps if s is not None]
    try:
        ms_present = np.asarray(present, np.int64)
    except (ValueError, TypeError):
        def to_ms(s):
            if isinstance(s, _dt.datetime):
                if s.tzinfo is None:
                    s = s.replace(tzinfo=_dt.timezone.utc)
                return int(s.timestamp() * 1000)
            if isinstance(s, _dt.date):
                return int(_dt.datetime(
                    s.year, s.month, s.day, tzinfo=_dt.timezone.utc,
                ).timestamp() * 1000)
            return None

        ms = [to_ms(s) for s in present]
        ms_present = (np.asarray(ms, np.int64)
                      if all(m is not None for m in ms) else None)
    if ms_present is not None:
        full = np.full(len(flat_stamps), TS_MISSING, np.int64)
        full[valid] = ms_present
        return {"timestamps_ms": full}
    return {
        "timestamps_str": np.asarray(
            ["" if s is None else str(s) for s in flat_stamps]),
        "timestamps_valid": valid,
    }


def _stamps_from_checkpoint(arrays, n) -> list:
    """Inverse of :func:`_stamps_to_checkpoint` for ``n`` rows."""
    if "timestamps_ms" in arrays:
        return [None if t == TS_MISSING else int(t)
                for t in arrays["timestamps_ms"]]
    if "timestamps_str" in arrays:
        if "timestamps_valid" in arrays:
            return [s if v else None
                    for s, v in zip(arrays["timestamps_str"],
                                    arrays["timestamps_valid"])]
        return list(arrays["timestamps_str"])
    return [None] * n


#: Why a checkpoint of the other job path is refused, per resuming path:
#: batch indices mean the same rows only under the reader that wrote them.
_RESUME_ELSEWHERE = {
    "fast": "resume it with the same path (run_job_resumable / drop "
            "--fast) or point --fast at a fresh checkpoint dir",
    "string": "resume it with run_job_fast (--fast) or point this run at "
              "a fresh checkpoint dir",
}


class _Ingest:
    """A job's ingest: reads source batches into their kept rows, holds
    those rows' columns across batches, and writes and restores the
    job's ingest checkpoint (the JAX package's npz keys, dtypes and
    metadata).

    The string reader filters with :func:`load_columns` and keeps the
    user strings, or with a ``vocab`` maps them to group ids per batch;
    the fast reader (``fast``) routes run_job_fast's batches into
    ``vocab`` through a :class:`_FastRouter`. The columns are latitude,
    longitude, users (strings or group ids), timestamps (a list on the
    string path, i64 epoch ms on the fast path) and, for weighted jobs,
    the 'value' weights. Arrays are kept as pieces and joined once;
    lists grow flat.
    """

    def __init__(self, config: BatchJobConfig, vocab: UserVocab | None = None,
                 fast: bool = False):
        self.weighted = config.weighted
        self.vocab = vocab
        self.router = _FastRouter(vocab) if fast else None
        self.job_path = "fast" if fast else "string"
        self._hold()

    def _hold(self, arrays=None, stamps=None):
        """Hold nothing, or the columns of checkpoint ``arrays`` (and the
        timestamps ``stamps``) as one piece each."""
        arrays = arrays or {}
        self._lat, self._lon, self._users, self._vals = (
            [arrays[k]] if k in arrays else []
            for k in ("latitude", "longitude", "group_ids", "values"))
        self._stamps = [] if stamps is None else stamps
        self._n = len(arrays.get("latitude", ()))

    def __len__(self) -> int:
        return self._n

    def read(self, batch):
        """-> (lat, lon, users, stamps, values_or_None): ``batch``'s kept
        rows; a weighted job refuses a batch without a 'value' column."""
        if self.router is not None:
            self.router.observe(batch)
            rows = self.router.route(batch)
            if self.weighted and rows[4] is None:
                raise ValueError(
                    "weighted fast job needs a 'value' column in the fast "
                    "batches (convert the source to HMPB from an input "
                    "with a 'value' column)"
                )
            return rows
        cols = load_columns(batch)
        if self.weighted and "value" not in cols:
            raise ValueError(
                "weighted job needs a 'value' column in the source "
                "(CSV/JSONL column named 'value')"
            )
        users = cols["user_id"]
        if self.vocab is not None:
            users = self.vocab.group_ids(users)
        return (cols["latitude"], cols["longitude"], users,
                cols["timestamp"], cols.get("value"))

    def skip(self, batch):
        """A batch whose rows an earlier run checkpointed: the fast
        reader's name table still grows, since later batches may
        reference ids first named in it."""
        if self.router is not None:
            self.router.observe(batch)

    def append(self, rows) -> int:
        """Hold :meth:`read`'s ``rows``; -> their count."""
        lat, lon, users, stamps, values = rows
        self._lat.append(lat)
        self._lon.append(lon)
        if self.vocab is None:
            self._users.extend(users)
        else:
            self._users.append(users)
        if self.router is None:
            self._stamps.extend(stamps)
        else:
            self._stamps.append(stamps)
        if self.weighted:
            self._vals.append(values)
        self._n += len(lat)
        return len(lat)

    def take(self):
        """-> the held columns joined, as (lat, lon, users, stamps,
        values_or_None), and nothing held after."""
        out = (
            np.concatenate(self._lat),
            np.concatenate(self._lon),
            self._users if self.vocab is None
            else np.concatenate(self._users).astype(np.int32, copy=False),
            np.concatenate(self._stamps) if self.router is not None
            else self._stamps,
            np.concatenate(self._vals) if self.weighted else None,
        )
        self._hold()
        return out

    def save(self, mgr: CheckpointManager, step: int):
        """Write the held columns as checkpoint ``step`` and collapse
        each to one piece, so later checkpoints do not recopy a growing
        list."""
        def joined(pieces, dtype=np.float64):
            return np.concatenate(pieces) if pieces else np.empty(0, dtype)

        arrays = {
            "latitude": joined(self._lat),
            "longitude": joined(self._lon),
            "group_ids": joined(self._users, np.int32),
        }
        if self.router is not None:
            arrays["timestamps_ms"] = joined(self._stamps, np.int64)
        if self.weighted:
            arrays["values"] = joined(self._vals)
        if self.router is None:
            arrays.update(_stamps_to_checkpoint(self._stamps))
        mgr.save(step, arrays, {
            "group_names": list(self.vocab.names),
            "batches_done": step,
            "job_path": self.job_path,
            "weighted": self.weighted,
        })
        self._hold(arrays, [arrays["timestamps_ms"]]
                   if self.router is not None else self._stamps)

    def restore(self, mgr: CheckpointManager, checkpoint_dir: str) -> int:
        """Hold the rows of ``mgr``'s newest checkpoint and name its
        groups in the vocab; -> the batches it covers (0 without one).
        A checkpoint of the other job path or ingest mode is refused:
        mixing counted and weighted rows would corrupt every blob, and
        checkpoints without the key are counted ones."""
        if mgr.latest_step() is None:
            return 0
        arrays, meta = mgr.load()
        kind = meta.get("job_path", "string")
        if kind != self.job_path:
            raise RuntimeError(
                f"checkpoint at {checkpoint_dir!r} was written by the "
                f"{kind!r} job path; {_RESUME_ELSEWHERE[self.job_path]}"
            )
        ck = bool(meta.get("weighted", False))
        if ck != bool(self.weighted):
            raise RuntimeError(
                f"checkpoint at {checkpoint_dir!r} was written by a "
                f"{'weighted' if ck else 'counted'} job; resume with the "
                f"matching weighted setting or a fresh checkpoint dir"
            )
        self._hold(arrays, [arrays["timestamps_ms"]] if self.router is not None
                   else _stamps_from_checkpoint(arrays,
                                                len(arrays["latitude"])))
        for name in meta["group_names"][1:]:  # [0] is always 'all'
            self.vocab.id_for(name)
        return meta["batches_done"]


def _fast_batches_for(source, batch_size, checkpointing=False):
    """The run_job_fast input contract: a CSV path goes to the native
    decoder, anything else needs ``fast_batches``."""
    if isinstance(source, str):
        if not native.available():
            raise RuntimeError(
                "run_job_fast on a CSV path needs the native decoder "
                "(make -C native failed or no toolchain); use "
                "run_job(CSVSource(path)) instead"
            )
        return native.parse_csv_batches(
            source, batch_size, fast=True,
            n_workers=1 if checkpointing else None,
        )
    if hasattr(source, "fast_batches"):
        return source.fast_batches(batch_size)
    raise TypeError(
        f"run_job_fast needs a CSV path or a fast-batch source "
        f"(got {type(source).__name__}); use run_job for generic sources"
    )


def _resolve_backend(config: BatchJobConfig, device,
                     n_emissions: int | None = None,
                     data_parallel: bool = False) -> str:
    """Resolve the cascade backend once per job and leave the JAX
    package's audit trail: a ``backend_resolved`` event saying how
    ``"auto"`` routed and why, and the ``points_binned_total`` counter
    when the emission count is known here. With telemetry off it is
    ``config.resolved_cascade_backend(device)`` and nothing else.

    When the mesh engages (``data_parallel``), the event also carries
    ``dispatch``, how the formulation knob resolved.
    """
    resolved = config.resolved_cascade_backend(device)
    if not obs.telemetry_enabled():
        return resolved
    if config.cascade_backend != "auto":
        reason = "explicit request"
    elif config.weighted:
        reason = ("weighted jobs stay on scatter (the bounded-integer "
                  "partitioned contract is an explicit opt-in)")
    elif resolved == "partitioned":
        reason = "count job on cuda -> partitioned segment-reduce kernel"
    else:
        reason = "cpu device -> torch scatter"
    if n_emissions is not None:
        obs.POINTS_BINNED.inc(int(n_emissions), backend=resolved)
    fields = {"requested": config.cascade_backend, "resolved": resolved,
              "reason": reason, "weighted": bool(config.weighted),
              "data_parallel": bool(data_parallel)}
    if data_parallel:
        fields["dispatch"] = config.resolved_dispatch
    if n_emissions is not None:
        fields["n_emissions"] = int(n_emissions)
    obs.emit("backend_resolved", **fields)
    return resolved


def _run_job_bounded(source, sink, config: BatchJobConfig,
                     batch_size: int, max_points: int,
                     overlap_ingest: bool = True, fast: bool = False,
                     spill_dir: str | None = None, device="cuda",
                     timer=None,
                     feeder_stats: feeder_mod.FeederStats | None = None):
    """Chunked cascade with a host-side merge of each level's aggregates.

    Chunks of at most ``max_points`` points run the whole cascade on
    ``device``, and each level's decoded (timespan, group, code) -> sum
    aggregates fold into one running table per level. UserVocab and
    TimespanVocab are shared across chunks, so ids stay consistent; each
    chunk packs its slots with its own group count, and egress re-packs
    them with the final vocab sizes.

    ``overlap_ingest``: a worker thread (pipeline/feeder.py) builds
    chunk N+1 (source IO, parsing, group routing) and copies its numeric
    columns to the device while this thread runs chunk N's cascade and
    merge, through a depth-1 queue: at most 3 chunks resident (building,
    queued, in the cascade). Chunk order, and so every vocab id and
    merge result, equals the sequential path's. False keeps one chunk.

    ``spill_dir``: write per-chunk level aggregates to disk instead of
    folding them in RAM, and merge one level at a time at egress
    (``_SpillMerge``); byte-identical results. Without it the job still
    spills on its own (to ``_auto_spill_target()``) once the in-RAM
    table passes AUTO_SPILL_ROWS and the projected volume fits the disk;
    a failed automatic spill folds back into RAM with a warning.
    """
    if max_points < 1:
        raise ValueError(f"max_points_in_flight must be >= 1, got {max_points}")
    device = resolve_device(device)
    tracer = get_tracer()
    vocab = UserVocab()
    ts_vocab = TimespanVocab()
    ccfg = config.cascade_config()
    n_levels = ccfg.n_levels + 1
    dp_mesh = _dp_mesh(config, device)
    # Resolved once for the whole job (no emission count yet: each
    # chunk adds its own to points_binned_total).
    backend = _resolve_backend(config, device,
                               data_parallel=dp_mesh is not None)
    empty = {
        "ts": np.empty(0, np.int64), "g": np.empty(0, np.int64),
        "code": np.empty(0, np.int64), "value": np.empty(0, np.float64),
    }
    merged = [dict(empty) for _ in range(n_levels)]
    spill = _SpillMerge(spill_dir, n_levels) if spill_dir is not None else None
    spill_runs = 0
    spill_is_auto = False
    # Candidate dir for automatic spill; None keeps the in-RAM fold.
    auto_spill_dir = _auto_spill_target() if spill is None else None
    est_points = _estimate_source_points(source)
    total_chunks_est = (
        None if est_points is None else -(-est_points // max_points)
    )
    chunks_done = 0
    max_chunk_rows = 0

    def chunks():
        """Sequential chunk builder: ingest batches, cut at max_points.

        A chunk is :meth:`_Ingest.take`'s (lat, lon, gids, stamps,
        weights).
        """
        ing = _Ingest(config, vocab, fast=fast)
        size = min(batch_size, max_points)
        batches = (_fast_batches_for(source, size) if fast
                   else source.batches(size))
        for batch in batches:
            with tracer.span("ingest.batch"):
                rows = ing.read(batch)
                m = len(rows[0])
                # Cut before appending when the batch would overshoot,
                # so a chunk never exceeds max_points.
                if len(ing) and len(ing) + m > max_points:
                    yield ing.take()
                ing.append(rows)
            tracer.add_items("ingest.batch", m)
            if len(ing) >= max_points:
                yield ing.take()
        if len(ing):
            yield ing.take()

    def process(chunk):
        nonlocal spill, spill_runs, spill_is_auto, auto_spill_dir
        nonlocal chunks_done, max_chunk_rows
        lat, lon, group_ids, flat_stamps, weights = chunk
        with tracer.span("cascade.chunk", items=len(lat), backend=backend):
            with stage(timer, "project"):
                codes, valid = project_codes(lat, lon, config.detail_zoom,
                                             device)
            with stage(timer, "emissions"):
                w = (None if weights is None else torch.as_tensor(
                    weights, dtype=torch.float64, device=device))
                e_codes, e_slots, e_valid, _, n_groups, e_weights = (
                    build_emissions(codes, valid, group_ids, flat_stamps,
                                    config, ts_vocab=ts_vocab, weights=w))
            n_emit = int(e_codes.shape[0])
            if obs.metrics_enabled():
                obs.POINTS_BINNED.inc(n_emit, backend=backend)
            # The mesh route's shard_map formulation with the replicated
            # or prefix merge, as the JAX bounded path runs it (no plan).
            level_data = cascade_mod.run_cascade(
                e_codes, e_slots, ccfg,
                n_slots=len(ts_vocab) * n_groups,
                valid=e_valid,
                capacity=min(config.capacity or n_emit, n_emit),
                weights=e_weights,
                acc_dtype=torch.float64 if e_weights is not None else None,
                backend=backend,
                weight_bound=config.weight_bound, timer=timer,
                adaptive=config.adaptive_capacity,
                mesh=_dp_mesh_for(dp_mesh, config, n_emit),
                merge=config.dp_merge,
            )
            with stage(timer, "decode"):
                levels = cascade_mod.decode_levels(level_data, ccfg)
        with tracer.span("merge.chunk"), stage(timer, "merge"):
            chunks_done += 1
            max_chunk_rows = max(
                max_chunk_rows, sum(len(lvl["code"]) for lvl in levels)
            )
            if spill is not None:
                failed_level = None
                try:
                    for i, lvl in enumerate(levels):
                        failed_level = i
                        spill.add_level(
                            spill_runs, i, lvl["slot"] // n_groups,
                            lvl["slot"] % n_groups, lvl["code"],
                            lvl["value"],
                        )
                except OSError as e:
                    if not spill_is_auto:
                        raise  # explicit merge_spill_dir: the operator's call
                    # An automatic spill hit a disk error: fold every
                    # spilled run, plus this chunk's unwritten levels,
                    # back into RAM and carry on without disk. Run order
                    # is kept, so results stay byte-identical. The level
                    # that raised may have its last file truncated, so
                    # its files are dropped by name.
                    spill.discard_level(spill_runs, failed_level)
                    written = spill.complete_levels(spill_runs)
                    written.discard(failed_level)
                    for i in range(n_levels):
                        base = spill.merge_level(i, spill_runs + 1)
                        if i not in written:
                            lvl = levels[i]
                            base = _merge_sorted_level(
                                base, lvl["slot"] // n_groups,
                                lvl["slot"] % n_groups, lvl["code"],
                                lvl["value"],
                            )
                        merged[i] = base
                    spill.cleanup()
                    spill = None
                    spill_is_auto = False
                    auto_spill_dir = None
                    warnings.warn(
                        f"auto-spill write failed ({e}); folded spilled "
                        "runs back into RAM and continuing without disk "
                        "(set TMPDIR or AUTO_SPILL_DIR to a larger "
                        "filesystem to re-enable)",
                        RuntimeWarning, stacklevel=2,
                    )
                else:
                    spill_runs += 1
                return
            for i, lvl in enumerate(levels):
                merged[i] = _merge_sorted_level(
                    merged[i], lvl["slot"] // n_groups,
                    lvl["slot"] % n_groups, lvl["code"], lvl["value"],
                )
            table_rows = sum(len(m["code"]) for m in merged)
            if auto_spill_dir is not None and table_rows > AUTO_SPILL_ROWS:
                # Past this size the in-RAM fold's per-chunk re-scan of
                # the whole table loses to the spill merge: convert the
                # table to spill run 0, and spill later chunks directly
                # (run order keeps chunk-order sums: byte-identical),
                # but only onto a filesystem the projected volume fits.
                if not _auto_spill_projection_fits(
                        auto_spill_dir, table_rows, chunks_done,
                        total_chunks_est, max_chunk_rows):
                    warnings.warn(
                        f"auto-spill skipped: projected spill volume "
                        f"does not fit {auto_spill_dir!r}; keeping the "
                        "in-RAM merge (set TMPDIR or AUTO_SPILL_DIR to a "
                        "larger filesystem, or pass merge_spill_dir)",
                        RuntimeWarning, stacklevel=2,
                    )
                    auto_spill_dir = None
                    return
                converting = None
                try:
                    converting = _SpillMerge(auto_spill_dir, n_levels)
                    for i, m in enumerate(merged):
                        converting.add_level(
                            0, i, m["ts"], m["g"], m["code"], m["value"]
                        )
                except OSError as e:
                    if converting is not None:
                        converting.cleanup()
                    auto_spill_dir = None
                    warnings.warn(
                        f"auto-spill conversion failed ({e}); keeping "
                        "the in-RAM merge",
                        RuntimeWarning, stacklevel=2,
                    )
                else:
                    spill = converting
                    spill_is_auto = True
                    for i in range(n_levels):
                        merged[i] = dict(empty)
                    spill_runs = 1

    # A failure between the first spilled run and egress must still
    # remove the spill tempdir, so ingest runs under the same cleanup.
    try:
        if not overlap_ingest:
            for chunk in chunks():
                process(chunk)
        else:
            transfer = (feeder_mod.CudaTransfer(device, columns=(0, 1, 4))
                        if device.type == "cuda" else (lambda chunk: chunk))
            for item in feeder_mod.feed(chunks(), transfer, depth=1,
                                        stats=feeder_stats,
                                        thread_name="ingest-prefetch"):
                process(feeder_mod.ready(item))
    except BaseException:
        if spill is not None:
            spill.cleanup()
        raise

    # Egress: re-pack slots with the complete vocabs, then the shared
    # finalize + blob path.
    n_groups = len(vocab)
    slot_names = _slot_names(vocab, ts_vocab, n_groups)

    def assemble(m, i):
        rows, cols_ = morton.morton_decode_np(m["code"])
        return {
            "zoom": ccfg.detail_zoom - i,
            "slot": m["ts"] * n_groups + m["g"],
            "code": m["code"],
            "row": rows,
            "col": cols_,
            "value": m["value"],
        }

    try:
        if spill is not None:
            if spill.rows_spilled == 0:
                return {}
            if not config.amplify_all:
                # One level at a time: merge, finalize and write each
                # level before the next, so the peak is one chunk plus
                # the largest level. Blob ids never collide across
                # levels (the coarse zoom is part of the id) and sinks
                # upsert per blob or per level, so per-level calls
                # compose exactly.
                out = None
                for i in range(n_levels):
                    part = _finish_blobs(
                        [assemble(spill.merge_level(i, spill_runs), i)],
                        ccfg, slot_names, as_json=True, sink=sink,
                        timer=timer,
                    )
                    if part.get("egress") == "levels":
                        if out is None:
                            out = {"egress": "levels", "levels": 0,
                                   "rows": 0}
                        out["levels"] += part["levels"]
                        out["rows"] += part["rows"]
                    else:
                        if out is None:
                            out = {}
                        out.update(part)
                return {} if out is None else out
            # amplify_all's cross-level recurrence needs every level in
            # hand (cascade._patch_amplified).
            merged = [spill.merge_level(i, spill_runs)
                      for i in range(n_levels)]
        elif all(len(m["code"]) == 0 for m in merged):
            return {}
        return _finish_blobs(
            [assemble(m, i) for i, m in enumerate(merged)],
            ccfg, slot_names, as_json=True, sink=sink, timer=timer,
        )
    finally:
        if spill is not None:
            spill.cleanup()


class _SpillMerge:
    """Disk-backed cross-chunk merge for the bounded path.

    The in-RAM merge table is O(unique output keys), the one bound
    ``max_points_in_flight`` cannot give. Spilling writes each chunk's
    decoded level aggregates as flat column files (24 B/row: int32 ts/g
    + int64 code + f64 value) and aggregates one level at a time at
    egress (mmap, concatenate, one stable sort, reduceat), so the host
    peak is one chunk plus the largest level (except under
    ``amplify_all``, whose cross-level recurrence needs every merged
    level at egress). Values sum in chunk order per key: byte-identical
    to the iterative in-RAM merge. The reference's analog is Spark's
    shuffle spill to local disk (reference submit-heatmap:14).
    """

    def __init__(self, root: str, n_levels: int):
        import tempfile

        os.makedirs(root, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="merge-spill-", dir=root)
        self.n_levels = n_levels
        self.rows_spilled = 0

    def _base(self, run: int, level: int) -> str:
        return os.path.join(self.dir, f"run{run:05d}_l{level:02d}")

    def add_level(self, run: int, level: int, ts, g, code, value) -> None:
        if len(code) == 0:
            return  # empty runs simply have no files
        base = self._base(run, level)
        np.save(base + "_ts.npy", np.asarray(ts, np.int32))
        np.save(base + "_g.npy", np.asarray(g, np.int32))
        np.save(base + "_code.npy", np.asarray(code, np.int64))
        np.save(base + "_value.npy", np.asarray(value, np.float64))
        self.rows_spilled += len(code)

    def discard_level(self, run: int, level: int | None) -> None:
        """Remove whatever ``(run, level)`` files exist: a save that
        raised may have left the last file truncated but present."""
        if level is None:
            return
        base = self._base(run, level)
        for name in ("ts", "g", "code", "value"):
            try:
                os.remove(f"{base}_{name}.npy")
            except OSError:
                pass

    def complete_levels(self, run: int) -> set:
        """Levels of ``run`` whose four column files all exist; the files
        of partial levels are deleted, so a later merge_level never
        reads a half-written run."""
        done = set()
        for level in range(self.n_levels):
            base = self._base(run, level)
            paths = [f"{base}_{name}.npy"
                     for name in ("ts", "g", "code", "value")]
            present = [p for p in paths if os.path.exists(p)]
            if len(present) == len(paths):
                done.add(level)
            else:
                for p in present:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
        return done

    def merge_level(self, level: int, n_runs: int) -> dict:
        cols = {"ts": [], "g": [], "code": [], "value": []}
        for run in range(n_runs):
            base = self._base(run, level)
            if not os.path.exists(base + "_code.npy"):
                continue
            for name in cols:
                cols[name].append(
                    np.load(f"{base}_{name}.npy", mmap_mode="r")
                )
        if not cols["code"]:
            return {
                "ts": np.empty(0, np.int64), "g": np.empty(0, np.int64),
                "code": np.empty(0, np.int64),
                "value": np.empty(0, np.float64),
            }
        ts = np.concatenate(cols["ts"]).astype(np.int64)
        g = np.concatenate(cols["g"]).astype(np.int64)
        code = np.concatenate(cols["code"])
        value = np.concatenate(cols["value"])
        return _aggregate_runs(ts, g, code, value)

    def cleanup(self) -> None:
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)


def _aggregate_runs(ts, g, code, value) -> dict:
    """Sum values over equal (ts, g, code) keys across concatenated runs;
    output sorted by (ts, g, code). The stable sort keeps run order
    within a key, so f64 sums accumulate in chunk order, the order of
    the iterative _merge_sorted_level fold."""
    pack = _level_key_packer(ts, g, code)
    if pack is not None:
        order = np.argsort(pack(ts, g, code), kind="stable")
    else:  # pathological widths: correct but slower full sort
        order = np.lexsort((code, g, ts))
    ts, g, code, value = ts[order], g[order], code[order], value[order]
    first = np.empty(len(code), bool)
    first[:1] = True
    first[1:] = (ts[1:] != ts[:-1]) | (g[1:] != g[:-1]) \
        | (code[1:] != code[:-1])
    starts = np.flatnonzero(first)
    return {
        "ts": ts[starts],
        "g": g[starts],
        "code": code[starts],
        "value": np.add.reduceat(value, starts) if len(starts)
        else value[:0],
    }


def _level_key_packer(ts, g, code):
    """Closure packing (ts, g, code) rows into one comparable int64,
    field widths taken from these arrays (pass the union of everything
    to be packed), or None when the widths do not fit 62 bits. Both merge
    paths order keys by it, which is what makes the spill merge
    byte-identical to the in-RAM one."""
    code_bits = int(code.max(initial=0)).bit_length()
    gmax = int(g.max(initial=0)) + 1
    tmax = int(ts.max(initial=0)) + 1
    if code_bits + (gmax * tmax).bit_length() >= 62:
        return None

    def pack(t_, g_, c_):
        # int64 first: ts/g arrive int32 off the native key decoder, and
        # << code_bits (up to 42 at z21) would wrap in int32, and
        # unsorted pack keys would then corrupt the merges.
        return ((t_.astype(np.int64) * gmax + g_) << code_bits) | c_

    return pack


def _merge_sorted_level(m, ts2, g2, code2, value2):
    """Fold one chunk's level aggregates into the running table.

    Both sides arrive sorted by (ts, g, code): the table is the previous
    merge's output, and decode_levels emits ascending composite-key
    order, which for slot = ts*G + g (g < G) is the (ts, g, code)
    order. So this is a two-sorted-run merge by binary searches, not a
    re-sort of the table per chunk. Equal keys sum.
    """
    ts = np.concatenate([m["ts"], ts2])
    g = np.concatenate([m["g"], g2])
    code = np.concatenate([m["code"], code2])
    value = np.concatenate([m["value"], value2])
    if len(code) == 0:
        return m
    pack = _level_key_packer(ts, g, code)
    if pack is not None:
        pa = pack(m["ts"], m["g"], m["code"])
        pb = pack(ts2, g2, code2)
        if len(pa) and len(pb):
            pos_a = np.arange(len(pa)) + np.searchsorted(pb, pa, side="left")
            pos_b = np.arange(len(pb)) + np.searchsorted(pa, pb, side="right")
            order = np.empty(len(pa) + len(pb), np.int64)
            order[pos_a] = np.arange(len(pa))
            order[pos_b] = len(pa) + np.arange(len(pb))
        else:
            order = np.arange(len(code))
    else:  # pathological widths: correct but slower full sort
        order = np.lexsort((code, g, ts))
    ts, g, code, value = ts[order], g[order], code[order], value[order]
    new = np.concatenate([[True],
                          (ts[1:] != ts[:-1]) | (g[1:] != g[:-1])
                          | (code[1:] != code[:-1])])
    seg = np.cumsum(new) - 1
    keep = np.flatnonzero(new)
    return {
        "ts": ts[keep], "g": g[keep], "code": code[keep],
        "value": np.bincount(seg, weights=value),
    }


def _finish_blobs(decoded_levels, ccfg, slot_names, as_json, sink=None,
                  timer=None):
    """Shared egress tail: finalize decoded levels, then either hand the
    columns to a columnar sink (anything with ``write_levels``, such as
    io.sinks.LevelArraysSink) and return ``{"egress": "levels",
    "levels": n, "rows": n}``, or build reference-format blobs, upsert
    them into ``sink`` and return them."""
    tracer = get_tracer()
    with stage(timer, "egress"):
        with tracer.span("egress.finalize"):
            finalized = cascade_mod.finalize_level_arrays(
                decoded_levels, ccfg, slot_names)
        if sink is not None and hasattr(sink, "write_levels"):
            with tracer.span("egress"):
                rows = sink.write_levels(finalized)
            return {"egress": "levels", "levels": len(finalized),
                    "rows": rows}
        with tracer.span("egress.blobs") as attrs:
            if as_json:
                blobs = cascade_mod.json_blobs_from_level_arrays(finalized)
                attrs["backend"] = cascade_mod.egress_path()
            else:
                blobs = cascade_mod.blobs_from_level_arrays(finalized)
        # Items in the tracer's report only: a stage_items series would
        # leave the telemetry of the JAX package's run.
        tracer.add_items("egress.blobs", len(blobs))
        if sink is not None:
            with tracer.span("egress"):
                sink.write(blobs.items())
    return blobs


def run_job_fast(source, sink=None, config: BatchJobConfig | None = None,
                 batch_size: int = 1 << 20,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 8,
                 fault_injector=None,
                 max_points_in_flight: int | None = None,
                 overlap_ingest: bool = True,
                 merge_spill_dir: str | None = None,
                 device="cuda", timer=None,
                 feeder_stats: feeder_mod.FeederStats | None = None):
    """Integer fast-path job: no per-row Python objects.

    ``source`` is a CSV path (the native decoder parses, routes user ids
    per reference heatmap.py:64-70 and flags background rows per
    heatmap.py:28-29 in its reader threads) or any object with
    ``fast_batches(batch_size)`` (io.hmpb.HMPBSource and HMPBDirSource
    memory-map pre-routed columns). This side maps the small routed-name
    table into the UserVocab and filters with numpy masks. Same blobs as
    the string path; dated timespans read the i64 epoch-ms ``timestamp``
    column (a TS_MISSING row under a dated timespan raises).

    ``checkpoint_dir`` enables checkpoint/resume with run_job_resumable's
    semantics, every ``checkpoint_every`` batches; a rerun skips the row
    work of checkpointed batches (the reader still streams them for its
    name table). Resume by batch index needs a deterministic batch
    order, so checkpointing runs the native CSV reader on one worker.
    ``fault_injector`` (utils.recovery.FaultInjector) fails chosen batch
    indices.

    ``max_points_in_flight`` chunks the job like run_job's knob, with
    fast ingest; it excludes ``checkpoint_dir`` and ``fault_injector``
    (chunk boundaries are not batch boundaries). ``None`` auto-routes
    like run_job unless checkpointing or fault injection is set.
    """
    config = config or BatchJobConfig()
    device = resolve_device(device)
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if (max_points_in_flight is None and checkpoint_dir is None
            and fault_injector is None):
        max_points_in_flight = _auto_points_in_flight(
            source, fast=True,
            n_timespans=(1 if config.first_timespan_only
                         else len(config.timespans)),
            weighted=config.weighted,
        )
    if merge_spill_dir is not None and not max_points_in_flight:
        raise ValueError(
            "merge_spill_dir lives on the bounded path, but this job "
            "routed single-shot; pass max_points_in_flight > 0 to "
            "chunk (see run_job)"
        )
    if max_points_in_flight:  # 0/None -> single-shot
        if checkpoint_dir is not None:
            raise ValueError(
                "max_points_in_flight and checkpoint_dir are mutually "
                "exclusive on the fast path"
            )
        if fault_injector is not None:
            raise ValueError(
                "fault_injector is not supported with "
                "max_points_in_flight (no batch-index resume on the "
                "chunked path)"
            )
        return _run_job_bounded(
            source, sink, config, batch_size, max_points_in_flight,
            overlap_ingest=overlap_ingest, fast=True,
            spill_dir=merge_spill_dir, device=device, timer=timer,
            feeder_stats=feeder_stats,
        )
    return _run_checkpointed(
        source, _Ingest(config, UserVocab(), fast=True), batch_size,
        checkpoint_dir, checkpoint_every, fault_injector, sink, config,
        device, timer)


def run_job_resumable(source, checkpoint_dir: str, sink=None,
                      config: BatchJobConfig | None = None,
                      batch_size: int = 1 << 20,
                      checkpoint_every: int = 8,
                      fault_injector=None, device="cuda", timer=None):
    """``run_job`` with checkpoint/resume over source batches.

    Ingest progress is checkpointed every ``checkpoint_every`` batches
    (atomic npz via utils.checkpoint, the JAX package's format); a rerun
    with the same source and batch size resumes after the last
    checkpointed batch. The source is streamed from the start on resume
    (earlier batches are read and skipped), so sources must iterate
    deterministically, as every built-in one does. ``fault_injector``
    (utils.recovery.FaultInjector) fails chosen batch indices.
    """
    config = config or BatchJobConfig()
    device = resolve_device(device)
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    return _run_checkpointed(
        source, _Ingest(config, UserVocab()), batch_size, checkpoint_dir,
        checkpoint_every, fault_injector, sink, config, device, timer)


def _run_checkpointed(source, ing: _Ingest, batch_size: int,
                      checkpoint_dir: str | None, checkpoint_every: int,
                      fault_injector, sink, config: BatchJobConfig,
                      device, timer):
    """run_job_fast's and run_job_resumable's single-shot job: ingest
    ``source`` with ``ing`` from where the checkpoint under
    ``checkpoint_dir`` (None: no checkpoints) left off, checkpoint every
    ``checkpoint_every`` batches, then run the cascade once."""
    tracer = get_tracer()
    mgr = None if checkpoint_dir is None else CheckpointManager(checkpoint_dir)
    done = 0 if mgr is None else ing.restore(mgr, checkpoint_dir)
    fast = ing.router is not None
    with (tracer.span("ingest.fast") if fast else contextlib.nullcontext()), \
            stage(timer, "ingest"):
        batches = (_fast_batches_for(source, batch_size,
                                     checkpointing=mgr is not None)
                   if fast else source.batches(batch_size))
        for i, batch in enumerate(batches):
            if i < done:
                ing.skip(batch)  # rows already checkpointed by an earlier run
                continue
            if fault_injector is not None:
                fault_injector.check(i)
            if fast:
                tracer.add_items("ingest.fast", len(batch["latitude"]))
                ing.append(ing.read(batch))
            else:
                with tracer.span("ingest.batch"):
                    m = ing.append(ing.read(batch))
                tracer.add_items("ingest.batch", m)
            done = i + 1
            if mgr is not None and done % checkpoint_every == 0:
                with tracer.span("checkpoint"):
                    ing.save(mgr, done)
    if not len(ing):
        return {}
    lat, lon, gids, stamps, values = ing.take()
    with tracer.span("cascade", items=len(lat)):
        return _run_grouped(lat, lon, gids, stamps, ing.vocab, config,
                            as_json=True, sink=sink, weights=values,
                            device=device, timer=timer)


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
    with stage(timer, "ingest"), stage_span("ingest.vocab"):
        group_ids = vocab.group_ids(data["user_id"])
    return _run_grouped(
        data["latitude"], data["longitude"], group_ids,
        data["timestamp"], vocab, config, as_json, sink=sink,
        weights=data.get("value") if config.weighted else None,
        device=device, timer=timer,
    )


def _dtype_name(t) -> str:
    """A tensor's dtype as numpy names it ("int64")."""
    return str(t.dtype).removeprefix("torch.")


#: Auto data-parallel engages only past this many emissions (explicit
#: ``data_parallel=True`` always engages): below it the per-shard slices
#: are too small for the shard dispatch and merge to pay for themselves
#: (the JAX package's threshold, kept so both route alike).
AUTO_DP_MIN_EMISSIONS = 1 << 18


def _dp_mesh(config: BatchJobConfig, device):
    """The mesh over the local devices of a job on ``device`` for the
    cascade's data-parallel route, or None for the single-device
    cascade. Capability gate only; :func:`_dp_mesh_for` is the per-call
    size gate. Auto engages only past one local device; under the
    shard_map dispatch adaptive capacities stay single-device, while
    the gspmd dispatch takes them onto the mesh."""
    if config.data_parallel is False:
        return None
    if config.adaptive_capacity and config.resolved_dispatch != "gspmd":
        return None
    from heatmap_tpu_torch.parallel import mesh as mesh_mod

    devices = mesh_mod.local_devices(device)
    if config.data_parallel is None and len(devices) < 2:
        return None
    return mesh_mod.make_mesh(devices=devices)


def _dp_mesh_for(mesh, config: BatchJobConfig, n_emissions: int,
                 plan=None):
    """The mesh to pass this cascade call, or None: auto engages only at
    AUTO_DP_MIN_EMISSIONS (or ``dp_min_emissions``) and up; explicit
    True always engages. A degenerate Morton ``plan`` (one range holds
    about all sampled mass) keeps the uniform mesh, recorded as a
    ``backend_resolved`` event; callers drop such a plan."""
    if mesh is None:
        return None
    threshold = (AUTO_DP_MIN_EMISSIONS if config.dp_min_emissions is None
                 else config.dp_min_emissions)
    if config.data_parallel is None and n_emissions < threshold:
        return None
    if plan is not None and plan.degenerate and obs.telemetry_enabled():
        obs.emit(
            "backend_resolved",
            requested=f"spatial_partition={config.spatial_partition}",
            resolved="uniform-dp",
            reason=("degenerate partition plan (max shard mass "
                    f"{max(plan.shard_mass or [0.0]):.3f}) would "
                    "serialize the cascade on one shard — falling "
                    "back to uniform DP"),
            spatial_partition=config.spatial_partition,
            n_emissions=int(n_emissions),
        )
    return mesh


def _partition_plan(mesh, config: BatchJobConfig, e_codes, e_valid):
    """The Morton partition plan of one cascade call on ``mesh``, or
    None: "auto" plans at the auto-DP threshold and up, "morton"
    whenever a mesh of two or more shards engages."""
    if mesh is None or config.spatial_partition == "off" or mesh.size < 2:
        return None
    threshold = (AUTO_DP_MIN_EMISSIONS if config.dp_min_emissions is None
                 else config.dp_min_emissions)
    if config.spatial_partition != "morton" and len(e_codes) < threshold:
        return None
    from heatmap_tpu_torch.parallel import partition as partition_mod

    with get_tracer().span("cascade.partition_plan", items=len(e_codes)):
        return partition_mod.plan_partition(
            e_codes.cpu().numpy(), mesh.size,
            detail_zoom=config.detail_zoom,
            valid=None if e_valid is None else e_valid.cpu().numpy(),
            n_levels=config.cascade_config().n_levels)


def _route(plan, config: BatchJobConfig, e_codes, e_slots, e_valid,
           e_weights):
    """Host-side range routing for the shard_map dispatch: each emission
    goes to its owning shard's contiguous segment (pad lanes invalid);
    segment lengths follow pad_bucketing. Returns device tensors."""
    from heatmap_tpu_torch.parallel import partition as partition_mod

    dev = e_codes.device
    bucket = None
    if config.pad_bucketing != "exact":
        def bucket(length):
            return bucketing_mod.bucket_size(
                length, config.pad_bucketing, config.pad_bucket_min)
    with get_tracer().span("cascade.partition_route", items=len(e_codes)):
        codes, slots, valid, weights, _seg = partition_mod.route_emissions(
            plan, e_codes.cpu().numpy(), e_slots.cpu().numpy(),
            None if e_valid is None else e_valid.cpu().numpy(),
            None if e_weights is None else e_weights.cpu().numpy(),
            bucket=bucket)
    return (torch.as_tensor(codes, device=dev),
            torch.as_tensor(slots, device=dev),
            torch.as_tensor(valid, device=dev),
            None if weights is None else torch.as_tensor(weights,
                                                         device=dev))


def _run_grouped(lat, lon, group_ids, timestamps, vocab,
                 config: BatchJobConfig, as_json: bool, sink=None,
                 weights=None, device="cuda", timer=None):
    if config.weighted and weights is None:
        raise ValueError("config.weighted needs per-point weights "
                         "(a 'value' column in the source)")
    device = resolve_device(device)
    tracer = get_tracer()
    with tracer.span("cascade.project", items=len(lat)), \
            stage(timer, "project"):
        codes, valid = project_codes(lat, lon, config.detail_zoom, device)
    with tracer.span("cascade.emissions"), stage(timer, "emissions"):
        w = None
        if config.weighted:
            w = (weights.to(device=device, dtype=torch.float64)
                 if isinstance(weights, torch.Tensor) else
                 torch.as_tensor(np.asarray(weights, np.float64),
                                 device=device))
        e_codes, e_slots, e_valid, ts_vocab, n_groups, e_weights = (
            build_emissions(codes, valid, group_ids, timestamps, config,
                            weights=w))
    n_slots = len(ts_vocab) * n_groups
    ccfg = config.cascade_config()
    if config.pad_bucketing != "exact":
        # Pad to the bucket on the card: capacity and n_slots are then
        # functions of the bucket, not of the batch (pipeline/bucketing.py).
        with tracer.span("cascade.bucket", items=len(e_codes)):
            target = bucketing_mod.bucket_size(
                len(e_codes), config.pad_bucketing, config.pad_bucket_min)
            e_codes, e_slots, e_valid, e_weights = (
                bucketing_mod.pad_emissions(
                    e_codes, e_slots, e_valid, e_weights, target))
            n_slots = bucketing_mod.bucket_slots(n_slots)
    mesh0 = _dp_mesh(config, device)
    plan = _partition_plan(mesh0, config, e_codes, e_valid)
    dp_mesh = _dp_mesh_for(mesh0, config, len(e_codes), plan=plan)
    if plan is not None and (dp_mesh is None or plan.degenerate):
        plan = None  # fallback recorded by _dp_mesh_for
    dispatch = config.resolved_dispatch if dp_mesh is not None else None
    dispatch_timer = obs.DispatchTimer(dispatch or "single")
    if plan is not None and dispatch != "gspmd":
        # The gspmd formulation routes on the device against the splits;
        # the shard_map one takes the emissions pre-routed.
        e_codes, e_slots, e_valid, e_weights = _route(
            plan, config, e_codes, e_slots, e_valid, e_weights)
    backend = _resolve_backend(config, device, n_emissions=len(e_codes),
                               data_parallel=dp_mesh is not None)
    with tracer.span("cascade.device", backend=backend):
        capacity = config.capacity or len(e_codes)
        acc_dtype = torch.float64 if e_weights is not None else None
        if not stage_tracing_enabled() and not config.adaptive_capacity:
            # The JAX package's jit cache key for this dispatch (shapes
            # and every static arg of its _build_cascade_jit): the mirror
            # counts what it would compile, so cache_stats() equals the
            # JAX package's.
            bucketing_mod.note_dispatch(
                (int(e_codes.shape[0]), _dtype_name(e_codes),
                 _dtype_name(e_slots), e_valid is not None,
                 None if e_weights is None else _dtype_name(e_weights),
                 ccfg, n_slots, capacity,
                 None if acc_dtype is None else "float64",
                 backend,
                 None if dp_mesh is None
                 else tuple(sorted(dp_mesh.shape.items())),
                 config.dp_merge, config.weight_bound,
                 None if plan is None else ("morton", len(plan.splits)),
                 dispatch),
                config.pad_bucketing)
        levels = cascade_mod.run_cascade(
            e_codes, e_slots, ccfg, n_slots=n_slots, valid=e_valid,
            capacity=capacity, weights=e_weights,
            # Weighted sums accumulate in f64; counts use int32.
            acc_dtype=acc_dtype, backend=backend,
            weight_bound=config.weight_bound, timer=timer,
            adaptive=config.adaptive_capacity, mesh=dp_mesh,
            merge=config.dp_merge,
            partition_splits=(None if plan is None else torch.as_tensor(
                plan.splits, dtype=torch.int64, device=e_codes.device)),
            dispatch=dispatch or "shard_map",
        )
        # Kernels enqueued; only while telemetry is on, the card is
        # synchronised so the host/device split times execution.
        dispatch_timer.dispatched()
        if dispatch_timer.enabled and e_codes.device.type == "cuda":
            torch.cuda.synchronize(e_codes.device)
        dispatch_timer.finished(items=len(e_codes))
        # Under stage tracing the span closes once the card has run the
        # cascade, so it times execution, not the enqueue.
        stage_block(None)
    with tracer.span("cascade.decode"), stage(timer, "decode"):
        decoded = cascade_mod.decode_levels(levels, ccfg)
    return _finish_blobs(decoded, ccfg, _slot_names(vocab, ts_vocab, n_groups),
                         as_json, sink=sink, timer=timer)

