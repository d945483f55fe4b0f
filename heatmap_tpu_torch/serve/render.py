"""On-demand tile materialization from a TileStore.

The port's copy of heatmap_tpu/serve/render.py: the same PNG (through
the port's ``io/png.py``) and JSON bytes for the same layer.

A request names a coarse tile ``(z, x, y)`` (slippy-map: x = column,
y = row). The payload is the block of detail counts ``result_delta``
zooms finer — the same fan-in as the reference blob format (32x32 at
DETAIL_ZOOM_DELTA=5, reference heatmap.py:16,89).

Stored zooms are exact: the detail tiles under a coarse tile occupy one
contiguous Morton range, so the query is a searchsorted pair in the
layer's sorted code array. Zooms the pyramid lacks are synthesized from
the nearest stored level:

- **rollup** (stored level finer than wanted): shift the stored codes
  right ``2*(d_src - d)`` — Morton parenthood is a right shift and
  preserves sort order — and segment-sum into the wanted cells; exact,
  identical to what the cascade itself would have produced.
- **quadrant upsample** (stored level coarser): each stored cell's
  value paints its whole quadrant block (np.kron with a ones block) —
  a constant-interpolation preview, clearly marked approximate.

JSON bodies at stored zooms byte-match the batch blob egress: blob
stores serve the verbatim on-disk document; columnar stores rebuild
``{detail_id: value}`` in stored Morton order, which is exactly the
within-blob entry order ``json_blobs_from_level_arrays`` emits (level
rows arrive composite-key-sorted), and ``json.dumps`` of round-trip
doubles matches numpy's shortest-roundtrip formatting byte-for-byte.
"""

from __future__ import annotations

import json

import numpy as np

from heatmap_tpu_torch.io.png import raster_to_png
from heatmap_tpu_torch.serve.store import Layer, TileStore
from heatmap_tpu_torch.tilemath.morton import morton_decode_np, morton_encode_np


def _tile_base_code(z: int, x: int, y: int) -> int:
    if not (0 <= x < (1 << z) and 0 <= y < (1 << z)):
        raise ValueError(f"tile ({z}/{x}/{y}) outside the zoom-{z} grid")
    return int(morton_encode_np(np.int64(y), np.int64(x)))


def tile_array(layer: Layer, z: int, x: int, y: int,
               pixel_delta: int | None = None):
    """(px, px) float64 counts raster for coarse tile (z, x, y) at
    detail zoom ``z + pixel_delta``, or None when no stored data
    intersects the tile. ``pixel_delta`` defaults to the layer's
    result_delta. Second return: the stored detail zoom used (for vmax
    consistency), or None."""
    delta = layer.result_delta if pixel_delta is None else pixel_delta
    if delta is None or not layer.levels:
        return None, None
    px = 1 << delta
    want = z + delta
    src = layer.source_zoom(want)
    if src is None:
        return None, None
    level = layer.levels[src]
    base = _tile_base_code(z, x, y)
    raster = np.zeros((px, px), np.float64)
    if src >= z:
        # The stored cells under this tile are one Morton range.
        shift = 2 * (src - z)
        codes, values = level.range(base << shift, (base + 1) << shift)
        if len(codes) == 0:
            return None, src
        rel = codes - (base << shift)
        if src >= want:
            # Exact or rollup: parent shift then bin (order-preserving,
            # so np.add.at degenerates to a segment sum).
            cell = rel >> np.int64(2 * (src - want))
            rr, cc = morton_decode_np(cell)
            np.add.at(raster, (rr.astype(np.int64), cc.astype(np.int64)),
                      values)
        else:
            # Stored coarser than wanted but finer than the tile zoom:
            # paint each stored cell's quadrant block.
            side = 1 << (src - z)
            small = np.zeros((side, side), np.float64)
            rr, cc = morton_decode_np(rel)
            np.add.at(small, (rr.astype(np.int64), cc.astype(np.int64)),
                      values)
            k = px // side
            raster = np.kron(small, np.ones((k, k)))
    else:
        # Whole requested tile lies inside ONE stored ancestor cell.
        value = level.lookup(base >> (2 * (z - src)))
        if value == 0.0:
            return None, src
        raster[:] = value
    if not raster.any():
        return None, src
    return raster, src


def _json_doc_from_level(layer: Layer, z: int, x: int, y: int):
    """Stored-zoom JSON document for a columnar store: detail ids ->
    values in stored Morton order (the blob egress entry order)."""
    delta = layer.result_delta
    want = z + delta
    level = layer.levels.get(want)
    if level is None:
        return None
    base = _tile_base_code(z, x, y)
    shift = 2 * delta
    codes, values = level.range(base << shift, (base + 1) << shift)
    if len(codes) == 0:
        return None
    rows, cols = morton_decode_np(codes)
    doc = {
        f"{want}_{int(r)}_{int(c)}": float(v)
        for r, c, v in zip(rows, cols, values)
    }
    return json.dumps(doc)


def tile_json_bytes(layer: Layer, z: int, x: int, y: int):
    """Reference-compatible JSON counts for (z, x, y), or None (-> 404).

    Byte-identical to the batch artifact at stored zooms (see module
    docstring); synthesized zooms serve the rollup/upsample raster's
    non-zero cells (row-major) at ``z + result_delta``.
    """
    raw = layer.blob_json.get((z, int(y), int(x)))
    if raw is not None:
        return raw.encode()
    doc = _json_doc_from_level(layer, z, x, y)
    if doc is not None:
        return doc.encode()
    raster, _ = tile_array(layer, z, x, y)
    if raster is None:
        return None
    delta = layer.result_delta
    want = z + delta
    rr, cc = np.nonzero(raster)
    doc = {
        f"{want}_{int(y) * (1 << delta) + int(r)}_"
        f"{int(x) * (1 << delta) + int(c)}": float(raster[r, c])
        for r, c in zip(rr, cc)
    }
    return json.dumps(doc).encode()


def tile_png_bytes(layer: Layer, z: int, x: int, y: int):
    """Heat-colormapped PNG tile (io/png.py), or None (-> 404). vmax is
    the source level's max so the colormap is consistent across tiles
    of one layer/zoom (the cmd_render shared-vmax convention)."""
    raster, src = tile_array(layer, z, x, y)
    if raster is None:
        return None
    vmax = layer.levels[src].vmax if src in layer.levels else None
    return raster_to_png(raster, vmax=vmax)


class SynopsisLayer:
    """Layer facade for synopsis rendering: the decoded synopsis level
    replaces the exact level at every zoom that carries one, so the
    rollup/upsample machinery above serves approximate tiles
    unchanged. ``blob_json`` is empty on purpose — verbatim on-disk
    documents are an exact-path contract."""

    __slots__ = ("user", "timespan", "result_delta", "levels", "blob_json")

    source_zoom = Layer.source_zoom

    def __init__(self, layer: Layer, *, max_level: int | None = None):
        self.user = layer.user
        self.timespan = layer.timespan
        self.result_delta = layer.result_delta
        self.levels = {
            z: (layer.synopses[z].level if z in layer.synopses else lvl)
            for z, lvl in layer.levels.items()
            # max_level caps the source ladder: the brownout stretch
            # path (synopsis_source(..., stretch=True)) pins rendering
            # to a synopsis-carrying zoom even when a finer exact level
            # exists — the upsample machinery paints the rest.
            if max_level is None or z <= max_level
        }
        self.blob_json = {}


def synopsis_source(layer: Layer, z: int, *, stretch: bool = False):
    """Decide whether tile zoom ``z`` can be served from a synopsis:
    returns ``(source_zoom, SynopsisView)`` when the SAME source level
    the exact path would pick carries a decoded synopsis, else
    ``(None, None)`` — the caller falls back to the exact path (and
    byte-identical output), which is what happens for every
    ``z + result_delta >= synopsis_max_z`` tile.

    ``stretch=True`` raises the synopsis zoom ceiling (the brownout
    ladder's rung 2): when the natural source carries no synopsis, the
    finest *coarser* synopsis-carrying level answers instead — the
    caller must then cap the layer at that zoom
    (``SynopsisLayer(layer, max_level=src)``) so the quadrant-upsample
    path paints the missing detail rather than the exact level
    reclaiming the render."""
    delta = layer.result_delta
    # Attached live layers (serve/live.py) have no synopses attribute;
    # they always take the exact path.
    if delta is None or not getattr(layer, "synopses", None):
        return None, None
    src = layer.source_zoom(z + delta)
    view = layer.synopses.get(src) if src is not None else None
    if view is None and stretch and src is not None:
        coarser = [s for s in layer.synopses if s < src]
        if coarser:
            src = max(coarser)
            view = layer.synopses[src]
    if view is None:
        return None, None
    return src, view


def render_tile(store: TileStore, layer_name: str, z: int, x: int, y: int,
                fmt: str, *, synopsis: bool = False):
    """Dispatch for the HTTP layer: bytes or None (missing layer or
    empty tile -> 404). ``synopsis=True`` renders from the layer's
    decoded synopsis views where available (callers gate on
    :func:`synopsis_source` first; with no synopsis at the source zoom
    this falls back to exact bytes)."""
    layer = store.layer(layer_name)
    if layer is None:
        return None
    if synopsis:
        src, view = synopsis_source(layer, z)
        if view is not None:
            layer = SynopsisLayer(layer)
    if fmt == "json":
        return tile_json_bytes(layer, z, x, y)
    if fmt == "png":
        return tile_png_bytes(layer, z, x, y)
    raise ValueError(f"unknown tile format {fmt!r}")
