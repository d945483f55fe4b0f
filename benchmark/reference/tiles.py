"""Web-Mercator rows and columns, as the reference computes them.

The reference's row of a point is CPython's scalar
``floor((1 - log(tan(phi) + 1/cos(phi)) / pi) / 2 * 2^zoom)`` with
``phi = lat * pi / 180`` (reference ``tile.py:16-21``). NumPy's vector
``tan``, ``cos`` and ``log`` may differ from the C library's in the last
bits, which can move a point that lies within a few units in the last
place of a row edge. So in float64 the rows of the lanes near an edge
are taken from the scalar formula; every other lane's floor is already
the scalar one. ``precision="float32"`` computes everything in float32
with no such recheck: the control of the benchmark's checks.
"""

from __future__ import annotations

import math

import numpy as np

#: Relative width of the band around a row edge that is recomputed with
#: the scalar formula, per unit of ``2^zoom`` and of the conditioning of
#: ``log(tan + sec)``: thousands of times the error of a vector ``tan``,
#: ``cos`` or ``log`` of a few units in the last place.
EDGE_BAND = 1e-12


def scalar_row(lat: float, zoom: int) -> float:
    """The reference's row (NaN where CPython's math refuses the point)."""
    try:
        phi = lat * math.pi / 180
        return float(math.floor(
            (1 - math.log(math.tan(phi) + 1 / math.cos(phi)) / math.pi)
            / 2 * (1 << zoom)))
    except (ValueError, OverflowError):
        return math.nan


def scalar_col(lon: float, zoom: int) -> int:
    return math.floor((lon + 180.0) / 360.0 * (1 << zoom))


def rows_cols(lat, lon, zoom: int, precision: str = "float64"):
    """``(row, col, ok)``: int64 rows and columns at ``zoom`` and the mask
    of points whose row and column are finite and inside the world grid
    (invalid lanes are 0)."""
    dt = np.float64 if precision == "float64" else np.float32
    lat = np.asarray(lat).astype(dt)
    lon = np.asarray(lon).astype(dt)
    n = dt(1 << zoom)
    with np.errstate(all="ignore"):
        phi = lat * dt(math.pi) / dt(180)
        t = np.tan(phi)
        s = dt(1) / np.cos(phi)
        u = t + s
        ny = (dt(1) - np.log(u) / dt(math.pi)) / dt(2) * n
        frow = np.floor(ny)
        if precision == "float64":
            cond = np.maximum((np.abs(t) + np.abs(s)) / np.abs(u), 1.0)
            band = EDGE_BAND * float(n) * cond
            near = ~(np.abs(ny - np.round(ny)) > band)  # NaN lanes too
            idx = np.flatnonzero(near)
            if len(idx):
                frow[idx] = [scalar_row(float(x), zoom) for x in lat[idx]]
        fcol = np.floor((lon + dt(180)) / dt(360) * n)
        ok = (np.isfinite(frow) & np.isfinite(fcol) & (frow >= 0)
              & (frow < n) & (fcol >= 0) & (fcol < n))
    row = np.where(ok, frow, 0).astype(np.int64)
    col = np.where(ok, fcol, 0).astype(np.int64)
    return row, col, ok


def window(lat_range, lon_range, zoom: int, align_levels: int,
           pad_multiple: int):
    """``(row0, col0, height, width)``: the smallest block of tiles at
    ``zoom`` that covers the box, its origin and sides on multiples of
    ``2^align_levels`` and its sides padded up to ``pad_multiple`` (the
    origin moved back where the padded block would leave the grid)."""
    n = 1 << zoom
    edge = math.degrees(math.atan(math.sinh(math.pi)))
    r_lo = max(int(scalar_row(min(max(lat_range), edge), zoom)), 0)
    r_hi = min(int(scalar_row(max(min(lat_range), -edge), zoom)), n - 1)
    c_lo = max(scalar_col(min(lon_range), zoom), 0)
    c_hi = min(scalar_col(max(lon_range), zoom), n - 1)
    a = 1 << align_levels
    m = math.lcm(pad_multiple, a)
    out = []
    for lo, hi in ((r_lo, r_hi), (c_lo, c_hi)):
        origin = lo // a * a
        side = -(-(hi + 1 - origin) // a) * a
        side = min(-(-side // m) * m, n)
        out.append((min(origin, max(0, n - side)), side))
    (row0, height), (col0, width) = out
    return row0, col0, height, width


def spread_bits(v):
    """Bits of ``v`` (int64, below 2^31) moved to the even positions."""
    v = np.asarray(v, np.int64) & 0x7FFFFFFF
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


def z_order(row, col):
    """Z-order (Morton) position of each tile: column bits at the even
    places, row bits at the odd ones."""
    return (spread_bits(row) << 1) | spread_bits(col)
