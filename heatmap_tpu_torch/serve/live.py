"""LiveLayer: serve a decaying HeatmapStream window as a tile layer.

The port's copy of heatmap_tpu/serve/live.py over the port's
``HeatmapStream``: the stream's raster (on the card unless the stream
was built for the CPU) is copied to the host once per micro-batch tick
and indexed like any stored level, so the HTTP frontend serves it
through the same store/cache/render machinery as batch layers. Request
threads read only the numpy ``Level``; only the tick's thread touches
the card.

Invalidation is **targeted**: each tick reports only the coarse tile
keys the batch's points actually landed in (per zoom, both formats),
as a ``TileKeySet`` (the keys of the JAX package's set, held as sorted
arrays), and the server drops just those cache entries
(``TileCache.invalidate_matching``). Exponential decay does drift every
*other* cached tile between renders — that staleness is bounded by the
cache TTL, which is why ``serve`` forces a finite TTL in live mode
instead of flushing the whole cache per tick.
"""

from __future__ import annotations

import threading

import numpy as np

from heatmap_tpu_torch.delta.compute import TileKeySet
from heatmap_tpu_torch.serve.store import Layer, Level
from heatmap_tpu_torch.tilemath.mercator import project_points_np
from heatmap_tpu_torch.tilemath.morton import morton_encode_np

#: Tile formats the HTTP layer caches under — one invalidation key per
#: (zoom, tile, format).
TILE_FORMATS = ("png", "json")


class LiveLayer(Layer):
    """A Layer whose single level is the stream's current window raster.

    ``tick(lat, lon, t)`` advances the stream one micro-batch, rebuilds
    the level from a fresh snapshot, and returns the cache keys to
    invalidate. Rebuild-on-tick (not on read) keeps the serving path
    lock-free: readers always see a complete, immutable Level; the swap
    is a single attribute store under ``_swap_lock``.
    """

    def __init__(self, stream, name: str = "live",
                 result_delta: int | None = None):
        window = stream.config.window
        delta = (min(5, int(window.zoom)) if result_delta is None
                 else int(result_delta))
        super().__init__(user=name, timespan="live", result_delta=delta)
        self.name = name
        self.stream = stream
        self.window = window
        self._swap_lock = threading.Lock()
        self._refresh()

    def _refresh(self):
        raster = self.stream.snapshot()  # the one device -> host copy
        rr, cc = np.nonzero(raster)
        level = Level(
            self.window.zoom,
            morton_encode_np(rr.astype(np.int64) + int(self.window.row0),
                             cc.astype(np.int64) + int(self.window.col0)),
            raster[rr, cc].astype(np.float64),
        )
        with self._swap_lock:
            self.levels = {int(self.window.zoom): level}

    def tick(self, lat, lon, t: float, weights=None) -> TileKeySet:
        """One micro-batch; returns the affected cache keys:
        ``(layer_name, z, x, y, fmt)`` for every coarse tile (at every
        zoom up to the window zoom) containing a batch point."""
        self.stream.update(lat, lon, t, weights=weights)
        self._refresh()
        return self.affected_keys(lat, lon)

    def affected_keys(self, lat, lon) -> TileKeySet:
        """The JAX package's key set for this batch, as a
        :class:`TileKeySet` (``set(keys)`` gives the tuples)."""
        zoom = int(self.window.zoom)
        row, col, valid = project_points_np(
            np.asarray(lat, np.float64), np.asarray(lon, np.float64), zoom)
        row, col = row[valid], col[valid]
        groups = []
        for z in range(zoom + 1):
            shift = zoom - z
            groups.append(((self.name,), z,
                           np.unique(((row >> shift) << 32)
                                     | (col >> shift))))
        return TileKeySet(groups)
