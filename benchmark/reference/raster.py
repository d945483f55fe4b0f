"""Window rasters and their 2x2 pyramid."""

from __future__ import annotations

import numpy as np

from benchmark.reference.tiles import rows_cols


def bin_window(lat, lon, zoom: int, win, precision: str = "float64"):
    """int64 counts of the points in each cell of ``win`` (``(row0,
    col0, height, width)`` at ``zoom``); points outside it are dropped."""
    row0, col0, h, w = win
    row, col, ok = rows_cols(lat, lon, zoom, precision)
    r = row - row0
    c = col - col0
    ok &= (r >= 0) & (r < h) & (c >= 0) & (c < w)
    cells = r[ok] * w + c[ok]
    return np.bincount(cells, minlength=h * w).reshape(h, w)


def pyramid(raster, levels: int):
    """``[raster, coarsened once, ...]``: up to ``levels`` sums over 2x2
    blocks, stopping where a side would drop below 2."""
    out = [np.asarray(raster, np.int64)]
    for _ in range(levels):
        r = out[-1]
        if min(r.shape) < 2:
            break
        h, w = r.shape
        out.append(r.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3)))
    return out

