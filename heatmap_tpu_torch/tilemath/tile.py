"""Scalar tile math in CPython doubles: the reference's own formulas.

Copy of the scalar helpers of heatmap_tpu/tilemath/tile.py (reference
tile.py:16-21). They run on the host with the platform libm, so their
rows and columns are the reference's bit for bit. ``window_from_bounds``
uses them, and ``mercator.project_points`` re-derives with them the rows
of points that lie within its error margin of a row edge.
"""

from __future__ import annotations

import math


def _row_from_latitude(latitude: float, zoom: int) -> float:
    # Same operation order as reference tile.py:17 (bit-identity contract).
    phi = latitude * math.pi / 180
    return math.floor(
        (1 - math.log(math.tan(phi) + 1 / math.cos(phi)) / math.pi) / 2 * (1 << zoom)
    )


def _column_from_longitude(longitude: float, zoom: int) -> float:
    return math.floor((longitude + 180.0) / 360.0 * (1 << zoom))
