"""Egress sinks: heatmap blob writers, per-level arrays, the PNG tile tree.

Port of heatmap_tpu/io/sinks.py: the memory, JSONL, directory and
Cassandra (``rhom.heatmaps``, reference heatmap.py:149-150) blob sinks,
the ``arrays:`` family and the PNG-tile sink.
Blob records are ``(id, heatmap)`` pairs where ``id`` is the composite
``user|timespan|coarseTileId`` key and ``heatmap`` the JSON dict of
detail-tile counts (reference heatmap.py:156-157). Every blob sink
upserts by id, like the reference's Cassandra ``append`` mode.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable

import numpy as np

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.io.png import raster_to_png


class BlobSink:
    """Base: consumes (id, heatmap-dict-or-json) records.

    ``write`` runs each ``write_one`` under the ``sink.write`` retry
    policy (faults/retry.py): the fault check fires before the write
    starts and every ``write_one`` is an upsert by id, so a retried
    write is idempotent."""

    #: Retry key and label of sink_blobs_written_total{sink=...}.
    KIND = "blob"

    def write(self, records: Iterable[tuple]) -> int:
        n = 0
        for blob_id, heatmap in records:
            faults.retry_call(self.write_one, blob_id, heatmap,
                              site="sink.write", key=self.KIND)
            n += 1
        if n and obs.metrics_enabled():
            obs.SINK_BLOBS.inc(n, sink=self.KIND)
        return n

    def write_one(self, blob_id: str, heatmap) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _as_json(heatmap) -> str:
    return heatmap if isinstance(heatmap, str) else json.dumps(heatmap)


class SinkConfigError(RuntimeError, faults.NonRetryable):
    """Deterministic sink misconfiguration: never retried."""


class MemorySink(BlobSink):
    """Dict-backed sink (tests, small jobs). Upsert-by-id."""

    KIND = "memory"

    def __init__(self):
        self.blobs: dict[str, str] = {}

    def write_one(self, blob_id, heatmap):
        self.blobs[blob_id] = _as_json(heatmap)

    def write(self, records) -> int:
        """Bulk write: one dict update per 16k blobs, each under the
        ``sink.write`` retry policy (an update is an upsert, so a retried
        chunk is idempotent). The batch job writes millions of blobs
        here; a retry call per blob would double the sink's time."""
        n = 0
        chunk = []
        for record in records:
            chunk.append(record)
            if len(chunk) >= 16384:
                n += self._update(chunk)
                chunk = []
        if chunk:
            n += self._update(chunk)
        if n and obs.metrics_enabled():
            obs.SINK_BLOBS.inc(n, sink=self.KIND)
        return n

    def _update(self, chunk) -> int:
        faults.retry_call(self.blobs.update,
                          [(k, _as_json(v)) for k, v in chunk],
                          site="sink.write", key=self.KIND)
        return len(chunk)


@dataclasses.dataclass
class JSONLBlobSink(BlobSink):
    """One ``{"id": ..., "heatmap": ...}`` JSON object per line;
    ``load`` applies last-write-wins per id."""

    path: str
    _f: object = dataclasses.field(default=None, repr=False)

    KIND = "jsonl"

    def _open(self):
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a")
        return self._f

    @staticmethod
    def _line(blob_id, heatmap) -> str:
        return json.dumps({"id": blob_id, "heatmap": _as_json(heatmap)})

    def write_one(self, blob_id, heatmap):
        self._open().write(self._line(blob_id, heatmap) + "\n")

    def write(self, records) -> int:
        """Bulk write: one ``writelines`` per 16k blobs, each under the
        ``sink.write`` retry policy."""
        f = self._open()
        n = 0
        nbytes = 0
        counting = obs.metrics_enabled()
        lines = []
        for blob_id, heatmap in records:
            lines.append(self._line(blob_id, heatmap) + "\n")
            if len(lines) >= 16384:
                faults.retry_call(f.writelines, lines, site="sink.write",
                                  key=self.KIND)
                n += len(lines)
                if counting:
                    nbytes += sum(len(ln) for ln in lines)
                lines.clear()
        if lines:
            faults.retry_call(f.writelines, lines, site="sink.write",
                              key=self.KIND)
            n += len(lines)
            if counting:
                nbytes += sum(len(ln) for ln in lines)
        if n and counting:
            obs.SINK_BLOBS.inc(n, sink=self.KIND)
            obs.SINK_BYTES.inc(nbytes, sink=self.KIND)
        return n

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    @staticmethod
    def load(path) -> dict[str, dict]:
        out: dict[str, dict] = {}
        with open(path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    out[rec["id"]] = json.loads(rec["heatmap"])
        return out


@dataclasses.dataclass
class DirectoryBlobSink(BlobSink):
    """``dir:PATH``: one file per blob id (id sanitized into a
    filename); overwrite = native upsert."""

    root: str

    KIND = "dir"

    def write_one(self, blob_id, heatmap):
        os.makedirs(self.root, exist_ok=True)
        fname = blob_id.replace(os.sep, "_") + ".json"
        with open(os.path.join(self.root, fname), "w") as f:
            f.write(_as_json(heatmap))


@dataclasses.dataclass
class CassandraBlobSink(BlobSink):
    """``cassandra:``: egress to ``rhom.heatmaps`` (reference
    heatmap.py:149-150; schema ``(id text PRIMARY KEY, heatmap text)``,
    reference heatmap.py:157), an upsert by id. Needs an injected
    ``session`` (``session.execute_async(cql, params) -> future`` with
    ``future.result()``, as a cassandra-driver session gives); keeps
    ``concurrency`` inserts in flight and drains them at close."""

    session: object = None
    keyspace: str = "rhom"  # reference heatmap.py:150
    table: str = "heatmaps"  # reference heatmap.py:150
    KIND = "cassandra"
    concurrency: int = 128
    _pending: list = dataclasses.field(default_factory=list, repr=False)

    def write_one(self, blob_id, heatmap):
        if self.session is None:
            raise SinkConfigError(
                "CassandraBlobSink needs a cassandra-driver session "
                "(not baked into this image); use JSONL/Directory sinks "
                "or inject session=..."
            )
        cql = (
            f"INSERT INTO {self.keyspace}.{self.table} (id, heatmap) "
            "VALUES (%s, %s)"
        )
        self._pending.append(
            self.session.execute_async(cql, (blob_id, _as_json(heatmap)))
        )
        if len(self._pending) >= self.concurrency:
            self._drain()

    def _drain(self):
        for fut in self._pending:
            fut.result()
        self._pending.clear()

    def close(self):
        if self._pending:
            self._drain()


@dataclasses.dataclass
class LevelArraysSink:
    """Columnar egress (``arrays:DIR``): one file per pyramid level.

    Consumes finalized level arrays (pipeline.cascade.
    finalize_level_arrays) directly: the information of the reference
    blob format (blob id = user|timespan|coarse tile + detail-tile
    counts, reference heatmap.py:54-55,79-90) as columns, with no
    per-blob Python dicts. Jobs route here when the sink has
    ``write_levels`` (pipeline.batch._finish_blobs).

    Files are ``level_z{zoom}.npz`` holding row/col/value,
    dictionary-encoded user/timespan (``user_idx``/``timespan_idx`` int32
    and the ``user_names``/``timespan_names`` tables), coarse_row/
    coarse_col and zoom/coarse_zoom, the arrays the JAX package's
    ``LevelArraysSink`` writes. ``format`` is ``"npz"`` (plain savez),
    ``"npz-compressed"`` or ``"parquet"`` (``arrays-parquet:DIR``;
    pyarrow, one ``level_z{zoom}.parquet`` with native dictionary
    columns ``user``/``timespan`` and per-row zoom columns). Each level
    is written to a temporary file and renamed into place, under the
    ``sink.write`` fault site, so a rerun upserts whole levels.

    ``synopses`` and ``integrals`` also publish the wavelet
    ``synopsis-z*.npz`` and summed-area ``integral-z*.npz`` side
    artifacts of the coarse levels, the JAX package's bytes (delta
    compaction sets both). ``tilefs`` also publishes the zero-copy
    ``tilefs-z*.bin`` mirrors the serving tier mmaps (``arrays-tilefs:``
    spec; heatmap_tpu_torch.tilefs). The ``arrays-synopsis:`` and
    ``arrays-integral:`` specs set ``synopses`` and ``integrals``.
    """

    path: str
    format: str = "npz"
    synopses: bool = False
    integrals: bool = False
    tilefs: bool = False

    #: Per-row columns (user/timespan dictionary-encoded).
    COLUMNS = ("row", "col", "value", "user_idx", "timespan_idx",
               "coarse_row", "coarse_col")

    def __post_init__(self):
        if self.format not in ("npz", "npz-compressed", "parquet"):
            raise ValueError(
                f"format must be 'npz', 'npz-compressed' or 'parquet', "
                f"got {self.format!r}")
        os.makedirs(self.path, exist_ok=True)

    def write_levels(self, levels) -> int:
        rows = 0
        if self.synopses or self.integrals or self.tilefs:
            levels = list(levels)  # consumed twice: levels + derived
        for lvl in levels:
            out = {k: np.asarray(lvl[k]) for k in self.COLUMNS}
            out["zoom"] = np.asarray(lvl["zoom"])
            out["coarse_zoom"] = np.asarray(lvl["coarse_zoom"])
            ext = "parquet" if self.format == "parquet" else "npz"
            final = os.path.join(self.path, f"level_z{lvl['zoom']:02d}.{ext}")
            tmp = final + ".tmp"

            def _publish_level():
                if self.format == "parquet":
                    _write_parquet_level(tmp, out, lvl)
                else:
                    save = (np.savez_compressed
                            if self.format == "npz-compressed" else np.savez)
                    with open(tmp, "wb") as f:
                        save(f, **out,
                             user_names=np.asarray(lvl["user_names"]),
                             timespan_names=np.asarray(lvl["timespan_names"]))
                os.replace(tmp, final)

            faults.retry_call(_publish_level, site="sink.write", key="arrays")
            rows += len(out["value"])
            if obs.metrics_enabled():
                obs.SINK_ROWS.inc(len(out["value"]), sink="arrays")
                obs.SINK_BYTES.inc(os.path.getsize(final), sink="arrays")
        if self.synopses:
            from heatmap_tpu_torch.synopsis import write_synopses

            write_synopses(self.path,
                           {int(lvl["zoom"]): lvl for lvl in levels})
        if self.integrals:
            from heatmap_tpu_torch.analytics import write_integrals

            write_integrals(self.path,
                            {int(lvl["zoom"]): lvl for lvl in levels})
        if self.tilefs:
            # Zero-copy mirrors from the same in-memory levels, split on
            # the string keys exactly like TileStore._build_from_levels.
            from heatmap_tpu_torch.tilefs import format as tilefs_format

            tilefs_format.write_tilefs_from_loaded(self.path, {
                int(lvl["zoom"]): {
                    "row": lvl["row"], "col": lvl["col"],
                    "value": lvl["value"],
                    "coarse_zoom": lvl["coarse_zoom"],
                    "user": np.asarray(lvl["user_names"])[
                        np.asarray(lvl["user_idx"])],
                    "timespan": np.asarray(lvl["timespan_names"])[
                        np.asarray(lvl["timespan_idx"])],
                } for lvl in levels})
        return rows

    def write(self, records):
        raise TypeError(
            "LevelArraysSink is columnar-only (write_levels); use a blob "
            "sink (jsonl:/dir:/memory:) for per-blob records")

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def load(path: str) -> dict:
        """{zoom: dict-of-columns} for every level file in ``path`` (npz or
        parquet), with ``user``/``timespan`` materialized as string
        columns and zoom/coarse_zoom as scalars either way."""
        out = {}
        for name in sorted(os.listdir(path)):
            if not name.startswith("level_z"):
                continue
            full = os.path.join(path, name)
            if name.endswith(".npz"):
                with np.load(full) as z:
                    cols = {k: z[k] for k in z.files}
                for col, names in (("user", "user_names"),
                                   ("timespan", "timespan_names")):
                    if names in cols:
                        cols[col] = cols[names][cols.pop(f"{col}_idx")]
                        del cols[names]
            elif name.endswith(".parquet"):
                cols = _read_parquet_level(full)
            else:
                continue
            out[int(cols["zoom"])] = cols
        return out


def _write_parquet_level(path, out, lvl):
    """One level as a parquet table: the row columns, ``user``/``timespan``
    as dictionary columns over the level's name tables, and zoom/
    coarse_zoom repeated per row (the JAX package's layout)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = len(out["value"])
    cols = {}
    for k, v in out.items():
        if k == "user_idx":
            cols["user"] = pa.DictionaryArray.from_arrays(
                pa.array(v), pa.array(lvl["user_names"]))
        elif k == "timespan_idx":
            cols["timespan"] = pa.DictionaryArray.from_arrays(
                pa.array(v), pa.array(lvl["timespan_names"]))
        else:
            cols[k] = np.full(n, v) if v.ndim == 0 else v
    pq.write_table(pa.table(cols), path)


def _read_parquet_level(path) -> dict:
    """A parquet level file as numpy columns, string columns decoded and
    the per-row zoom columns back to scalars."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pq.read_table(path)
    cols = {}
    for k in t.column_names:
        c = t[k].combine_chunks()
        if pa.types.is_dictionary(c.type):
            cols[k] = np.asarray(c.dictionary_decode()).astype(str)
        elif pa.types.is_string(c.type):
            cols[k] = np.asarray(c).astype(str)
        else:
            cols[k] = np.asarray(c)
    for k in ("zoom", "coarse_zoom"):
        cols[k] = np.asarray(cols[k][0]) if len(cols[k]) else cols[k]
    return cols


@dataclasses.dataclass
class PNGTileSink:
    """Slippy-map PNG tile tree: ``root/z/x/y.png``.

    Renders dense window rasters (ops.histogram.Window layout: rows are
    tile rows, cols are tile columns at ``window.zoom``) into standard
    z/x/y web-map tiles of ``2^pixel_delta`` pixels, one pixel per
    detail cell ``pixel_delta`` zooms finer."""

    root: str
    pixel_delta: int = 8
    log_scale: bool = True

    def write_window(self, raster, window, vmax=None) -> int:
        """Write all complete z/x/y tiles covered by ``raster`` (a
        (window.height, window.width) host array at window.zoom). Tile
        zoom is ``window.zoom - pixel_delta``. Returns #tiles."""
        raster = np.asarray(raster)
        px = 1 << self.pixel_delta
        tz = window.zoom - self.pixel_delta
        if tz < 0:
            raise ValueError(
                f"window zoom {window.zoom} < pixel_delta {self.pixel_delta}"
            )
        if window.row0 % px or window.col0 % px:
            raise ValueError("window origin must align to tile size")
        n_ty, n_tx = raster.shape[0] // px, raster.shape[1] // px
        vmax = vmax if vmax is not None else float(raster.max() or 1)
        count = 0
        for ty in range(n_ty):
            for tx in range(n_tx):
                block = raster[ty * px : (ty + 1) * px, tx * px : (tx + 1) * px]
                if not block.any():
                    continue
                y = window.row0 // px + ty
                x = window.col0 // px + tx
                d = os.path.join(self.root, str(tz), str(x))
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, f"{y}.png"), "wb") as f:
                    f.write(
                        raster_to_png(block, log_scale=self.log_scale, vmax=vmax)
                    )
                count += 1
        return count


def per_process_sink_spec(spec: str, process_index: int) -> str:
    """This process's sink spec for sharded multi-host egress: file
    sinks get a ``.pNNN`` suffix, directory sinks a ``hostNNN/``
    subdirectory, and ``memory:`` and ``cassandra:`` stay as they are
    (the JAX package's derivation)."""
    kind, _, rest = spec.partition(":")
    tag = f"p{process_index:03d}"
    if kind == "jsonl" or (not rest and spec.endswith((".jsonl", ".ndjson"))):
        path = rest or spec
        return f"jsonl:{path}.{tag}"
    if kind in ("arrays", "arrays-parquet", "arrays-synopsis",
                "arrays-integral", "arrays-tilefs", "dir"):
        return f"{kind}:{os.path.join(rest, 'host' + f'{process_index:03d}')}"
    if kind in ("memory", "cassandra"):
        return spec
    raise ValueError(f"unrecognized sink spec {spec!r}")


#: Sink spec kinds ``open_sink`` accepts, in help order.
SINK_KINDS = ("jsonl", "arrays", "arrays-parquet", "arrays-synopsis",
              "arrays-integral", "arrays-tilefs", "dir", "memory",
              "cassandra")


def validate_sink_spec(spec: str) -> str:
    """Reject an unknown sink kind with a one-line error naming the
    valid ones. Meant for argument-parse time: a typo like ``josnl:x``
    fails before any device work or ingest. Returns ``spec`` so it can
    wrap an argparse ``type=``."""
    kind, sep, _ = spec.partition(":")
    if (sep and kind in SINK_KINDS) or spec.endswith((".jsonl", ".ndjson")):
        return spec
    raise ValueError(
        f"unrecognized sink spec {spec!r}: kind must be one of "
        f"{', '.join(SINK_KINDS)} (e.g. jsonl:blobs.jsonl), or a bare "
        f".jsonl/.ndjson path"
    )


def open_sink(spec: str):
    """Sink spec: ``memory:``, ``jsonl:PATH``, ``dir:PATH``, ``arrays:DIR``
    (columnar per-level npz), ``arrays-parquet:DIR``,
    ``arrays-synopsis:DIR`` and ``arrays-integral:DIR`` (the npz levels
    plus their synopses or summed-area tables), ``arrays-tilefs:DIR``
    (the npz levels plus their tilefs mirrors), ``cassandra:`` (a
    ``CassandraBlobSink`` with no session: its first write raises
    ``SinkConfigError``, as the JAX package's does) or a bare ``.jsonl``
    path."""
    validate_sink_spec(spec)
    kind, sep, rest = spec.partition(":")
    if kind == "memory":
        return MemorySink()
    if kind == "jsonl":
        return JSONLBlobSink(rest)
    if kind == "dir":
        return DirectoryBlobSink(rest)
    if kind == "arrays":
        return LevelArraysSink(rest)
    if kind == "arrays-parquet":
        return LevelArraysSink(rest, format="parquet")
    if kind == "arrays-synopsis":
        return LevelArraysSink(rest, synopses=True)
    if kind == "arrays-integral":
        return LevelArraysSink(rest, integrals=True)
    if kind == "arrays-tilefs":
        return LevelArraysSink(rest, tilefs=True)
    if kind == "cassandra":
        return CassandraBlobSink()
    return JSONLBlobSink(spec)
