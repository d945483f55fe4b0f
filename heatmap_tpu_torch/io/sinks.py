"""Egress sinks: heatmap blob writers, per-level arrays, the PNG tile tree.

Port of the memory, JSONL, ``arrays:`` and PNG-tile sinks of
heatmap_tpu/io/sinks.py.
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

from heatmap_tpu_torch import faults
from heatmap_tpu_torch.io.png import raster_to_png


class BlobSink:
    """Base: consumes (id, heatmap-dict-or-json) records."""

    def write(self, records: Iterable[tuple]) -> int:
        n = 0
        for blob_id, heatmap in records:
            self.write_one(blob_id, heatmap)
            n += 1
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


class MemorySink(BlobSink):
    """Dict-backed sink (tests, small jobs). Upsert-by-id."""

    def __init__(self):
        self.blobs: dict[str, str] = {}

    def write_one(self, blob_id, heatmap):
        self.blobs[blob_id] = _as_json(heatmap)


@dataclasses.dataclass
class JSONLBlobSink(BlobSink):
    """One ``{"id": ..., "heatmap": ...}`` JSON object per line;
    ``load`` applies last-write-wins per id."""

    path: str
    _f: object = dataclasses.field(default=None, repr=False)

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
        """Bulk write: one ``writelines`` per 16k blobs."""
        f = self._open()
        n = 0
        lines = []
        for blob_id, heatmap in records:
            lines.append(self._line(blob_id, heatmap) + "\n")
            if len(lines) >= 16384:
                f.writelines(lines)
                n += len(lines)
                lines.clear()
        if lines:
            f.writelines(lines)
            n += len(lines)
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
class LevelArraysSink:
    """Columnar egress (``arrays:DIR``): one ``.npz`` per pyramid level.

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
    ``LevelArraysSink`` writes. ``format`` is ``"npz"`` (plain savez) or
    ``"npz-compressed"``; the JAX package's parquet format and its
    synopsis, integral and tilefs side artifacts are not ported. Each
    level is written to a temporary file and renamed into place, under
    the ``sink.write`` fault site, so a rerun upserts whole levels.
    """

    path: str
    format: str = "npz"

    #: Per-row columns (user/timespan dictionary-encoded).
    COLUMNS = ("row", "col", "value", "user_idx", "timespan_idx",
               "coarse_row", "coarse_col")

    def __post_init__(self):
        if self.format not in ("npz", "npz-compressed"):
            raise ValueError(
                f"format must be 'npz' or 'npz-compressed', got "
                f"{self.format!r}")
        os.makedirs(self.path, exist_ok=True)

    def write_levels(self, levels) -> int:
        rows = 0
        save = (np.savez_compressed if self.format == "npz-compressed"
                else np.savez)
        for lvl in levels:
            out = {k: np.asarray(lvl[k]) for k in self.COLUMNS}
            out["zoom"] = np.asarray(lvl["zoom"])
            out["coarse_zoom"] = np.asarray(lvl["coarse_zoom"])
            out["user_names"] = np.asarray(lvl["user_names"])
            out["timespan_names"] = np.asarray(lvl["timespan_names"])
            final = os.path.join(self.path, f"level_z{lvl['zoom']:02d}.npz")
            tmp = final + ".tmp"

            def _publish_level():
                with open(tmp, "wb") as f:
                    save(f, **out)
                os.replace(tmp, final)

            faults.retry_call(_publish_level, site="sink.write", key="arrays")
            rows += len(out["value"])
        return rows

    def write(self, records):
        raise TypeError(
            "LevelArraysSink is columnar-only (write_levels); use a blob "
            "sink (jsonl:/memory:) for per-blob records")

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def load(path: str) -> dict:
        """{zoom: dict-of-columns} for every level file in ``path``, with
        ``user``/``timespan`` materialized as string columns."""
        out = {}
        for name in sorted(os.listdir(path)):
            if not (name.startswith("level_z") and name.endswith(".npz")):
                continue
            with np.load(os.path.join(path, name)) as z:
                cols = {k: z[k] for k in z.files}
            for col, names in (("user", "user_names"),
                               ("timespan", "timespan_names")):
                if names in cols:
                    cols[col] = cols[names][cols.pop(f"{col}_idx")]
                    del cols[names]
            out[int(cols["zoom"])] = cols
        return out


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


def open_sink(spec: str):
    """Sink spec: ``memory:``, ``jsonl:PATH``, ``arrays:DIR`` (columnar
    per-level npz) or a bare ``.jsonl`` path."""
    kind, sep, rest = spec.partition(":")
    if sep and kind == "memory":
        return MemorySink()
    if sep and kind == "jsonl":
        return JSONLBlobSink(rest)
    if sep and kind == "arrays":
        return LevelArraysSink(rest)
    if spec.endswith((".jsonl", ".ndjson")):
        return JSONLBlobSink(spec)
    raise ValueError(
        f"unrecognized sink spec {spec!r}: use memory:, jsonl:PATH, "
        "arrays:DIR or a bare .jsonl/.ndjson path"
    )
