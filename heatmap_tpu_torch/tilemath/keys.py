"""Integer tile keys and the string-id compatibility codec.

The port's copy of heatmap_tpu/tilemath/keys.py: the packed keys are
int64 torch tensors (the port is always 64-bit), everything else is the
same host code. The reference addresses tiles with ``"zoom_row_col"``
strings (reference tile.py:32-58); here tiles are integers:

- ``(row, col)`` pairs at a given zoom;
- a packed int64 ``pack_key(zoom, row, col)`` when a single sortable
  scalar is needed;
- Morton codes (see morton.py) when pyramid-order locality is needed.

Parent/child navigation is pure bit arithmetic, ``parent = (r>>1,
c>>1)``, which equals the reference's center re-projection for in-range
tiles: the tile center lies strictly inside the tile, so re-binning it
one zoom coarser lands on the half-resolution tile.

Strings appear only at the egress boundary (the serve tier's layer ids,
``render``'s blob ids).
"""

from __future__ import annotations

import numpy as np
import torch

# Packed-key layout: | zoom:6 | row:29 | col:29 | — zooms 0..29 lossless.
_ROW_BITS = 29
_COL_BITS = 29
MAX_PACK_ZOOM = 29


def pack_key(zoom, row, col):
    """Pack (zoom, row, col) into a sortable int64 key tensor.

    Sort order is (zoom, row, col) lexicographic. A zoom above
    ``MAX_PACK_ZOOM`` raises, as the reference does for concrete zooms.
    """
    z = torch.as_tensor(zoom, dtype=torch.int64)
    if z.numel() and int(z.max()) > MAX_PACK_ZOOM:
        raise ValueError(
            f"pack_key fields hold zooms <= {MAX_PACK_ZOOM}; got {zoom}")
    r = torch.as_tensor(row, dtype=torch.int64, device=z.device)
    c = torch.as_tensor(col, dtype=torch.int64, device=z.device)
    return (z << (_ROW_BITS + _COL_BITS)) | (r << _COL_BITS) | c


def unpack_key(key):
    """Inverse of :func:`pack_key` -> (zoom, row, col) int32 tensors."""
    k = torch.as_tensor(key, dtype=torch.int64)
    col = (k & ((1 << _COL_BITS) - 1)).to(torch.int32)
    row = ((k >> _COL_BITS) & ((1 << _ROW_BITS) - 1)).to(torch.int32)
    zoom = (k >> (_ROW_BITS + _COL_BITS)).to(torch.int32)
    return zoom, row, col


def parent_rowcol(row, col):
    """Tile at zoom-1 containing (row, col): a right shift."""
    return row >> 1, col >> 1


def rowcol_at_zoom(row, col, from_zoom, to_zoom):
    """Re-bin a tile's (row, col) from ``from_zoom`` to a coarser ``to_zoom``."""
    if to_zoom > from_zoom:
        raise ValueError(
            f"rowcol_at_zoom only coarsens: from_zoom={from_zoom} -> to_zoom={to_zoom}"
        )
    shift = from_zoom - to_zoom
    return row >> shift, col >> shift


def children_rowcol(row, col):
    """The four zoom+1 children of (row, col) as ((r,c) x 4), the set
    the reference's quadrant-midpoint re-binning gives (reference
    tile.py:88-98)."""
    r2, c2 = row * 2, col * 2
    return ((r2, c2), (r2, c2 + 1), (r2 + 1, c2), (r2 + 1, c2 + 1))


def tile_id_string(zoom, row, col) -> str:
    """Reference-format tile id string (reference tile.py:56-58)."""
    return f"{int(zoom)}_{int(row)}_{int(col)}"


def parse_tile_id(tile_id: str):
    """Parse ``"zoom_row_col"`` -> (zoom, row, col) or None if malformed
    (None-on-malformed mirrors reference tile.py:33-36)."""
    parts = tile_id.split("_")
    if len(parts) != 3:
        return None
    try:
        return int(parts[0]), int(parts[1]), int(parts[2])
    except ValueError:
        return None


def tile_id_from_lat_long(latitude, longitude, zoom) -> str:
    """Scalar host-side id (reference tile.py:8-13), from the CPython
    scalar projection, so results agree with the reference bit-for-bit."""
    from heatmap_tpu_torch.tilemath import tile as _tile

    row = int(_tile._row_from_latitude(latitude, zoom))
    col = int(_tile._column_from_longitude(longitude, zoom))
    return tile_id_string(zoom, row, col)


def tile_ids_to_arrays(tile_ids):
    """String ids -> (zoom, row, col) int32 numpy arrays plus the
    keep-mask; malformed ids are dropped (reference tile.py:35-36)."""
    zooms, rows, cols, keep = [], [], [], []
    for tid in tile_ids:
        parsed = parse_tile_id(tid)
        if parsed is None:
            keep.append(False)
            continue
        keep.append(True)
        z, r, c = parsed
        zooms.append(z)
        rows.append(r)
        cols.append(c)
    return (
        np.asarray(zooms, np.int32),
        np.asarray(rows, np.int32),
        np.asarray(cols, np.int32),
        np.asarray(keep, bool),
    )
