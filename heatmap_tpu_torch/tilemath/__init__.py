"""Tile math of the port: f64 Web-Mercator projection (forward and
inverse), integer tile keys, Morton codes and the reference's scalar
``Tile`` class.

Semantics contract with the reference (reference tile.py:8-30):
floor-based binning, no pole clamping, no antimeridian wraparound.
"""

from heatmap_tpu_torch.tilemath.keys import (
    children_rowcol,
    pack_key,
    parent_rowcol,
    parse_tile_id,
    rowcol_at_zoom,
    tile_id_from_lat_long,
    tile_id_string,
    unpack_key,
)
from heatmap_tpu_torch.tilemath.mercator import (
    MAX_LATITUDE,
    column_from_longitude,
    latitude_from_row,
    longitude_from_column,
    mercator_x,
    mercator_y,
    project_points,
    row_from_latitude,
)
from heatmap_tpu_torch.tilemath.morton import (
    morton_decode,
    morton_encode,
    morton_parent,
    morton_range_shards_np,
    split_boundary_codes_np,
)
from heatmap_tpu_torch.tilemath.tile import Tile

__all__ = [
    "MAX_LATITUDE", "Tile", "children_rowcol", "column_from_longitude",
    "latitude_from_row", "longitude_from_column", "mercator_x",
    "mercator_y", "morton_decode", "morton_encode", "morton_parent",
    "morton_range_shards_np", "pack_key", "parent_rowcol",
    "parse_tile_id", "project_points", "row_from_latitude",
    "rowcol_at_zoom", "split_boundary_codes_np", "tile_id_from_lat_long",
    "tile_id_string", "unpack_key",
]
