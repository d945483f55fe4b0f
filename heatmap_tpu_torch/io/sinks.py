"""Egress sinks: heatmap blob writers and the PNG tile tree.

Port of the memory, JSONL and PNG-tile sinks of heatmap_tpu/io/sinks.py.
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


def open_sink(spec: str) -> BlobSink:
    """Sink spec: ``memory:``, ``jsonl:PATH`` or a bare ``.jsonl`` path."""
    kind, sep, rest = spec.partition(":")
    if sep and kind == "memory":
        return MemorySink()
    if sep and kind == "jsonl":
        return JSONLBlobSink(rest)
    if spec.endswith((".jsonl", ".ndjson")):
        return JSONLBlobSink(spec)
    raise ValueError(
        f"unrecognized sink spec {spec!r}: use memory:, jsonl:PATH or a "
        "bare .jsonl/.ndjson path"
    )
