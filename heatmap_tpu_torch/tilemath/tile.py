"""``Tile``, the reference's scalar tile class, and its CPython-double math.

Copy of heatmap_tpu/tilemath/tile.py: the API surface of the
reference's ``Tile`` (reference tile.py:3-98), the same classmethods,
instance methods and attribute names, including the public-but-unused
ones (``decode_tile_id``, ``tile_ids_for_all_zoom_levels``; SURVEY.md
§8.11). Host-side Python on CPython floats (the platform libm's
doubles), so ids agree with the reference bit for bit. Device code uses
the vectorised ``tilemath`` functions and integer keys, never this
class; ``window_from_bounds`` uses the scalar helpers, and
``mercator.project_points`` re-derives with them the rows of points
that lie within its error margin of a row edge.
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


def _latitude_from_row(row: float, zoom: int) -> float:
    n = math.pi - 2.0 * math.pi * row / (1 << zoom)
    return 180.0 / math.pi * math.atan(0.5 * (math.exp(n) - math.exp(-n)))


def _longitude_from_column(column: float, zoom: int) -> float:
    return float(column) / (1 << zoom) * 360.0 - 180.0


class Tile:
    """Web-Mercator map tile with reference-compatible geometry accessors."""

    MAX_ZOOM = 16
    MIN_ZOOM = 0

    tile_id: str
    zoom: int
    row: int
    column: int
    latitude_north: float
    latitude_south: float
    longitude_west: float
    longitude_east: float
    center_latitude: float
    center_longitude: float

    # -- projection classmethods (reference tile.py:8-30) ------------------

    @classmethod
    def row_from_latitude(cls, latitude, zoom):
        return _row_from_latitude(latitude, zoom)

    @classmethod
    def column_from_longitude(cls, longitude, zoom):
        return _column_from_longitude(longitude, zoom)

    @classmethod
    def latitude_from_row(cls, row, zoom):
        return _latitude_from_row(row, zoom)

    @classmethod
    def longitude_from_column(cls, column, zoom):
        return _longitude_from_column(column, zoom)

    @classmethod
    def tile_id_from_lat_long(cls, latitude, longitude, zoom):
        row = int(_row_from_latitude(latitude, zoom))
        column = int(_column_from_longitude(longitude, zoom))
        return cls.tile_id_from_row_column(row, column, zoom)

    @classmethod
    def tile_id_from_row_column(cls, row, column, zoom):
        return f"{zoom}_{row}_{column}"

    # -- constructors / codecs (reference tile.py:32-77) -------------------

    @classmethod
    def tile_from_tile_id(cls, tile_id):
        # Parity note: only a wrong part-count returns None (reference
        # tile.py:35-36); 3 non-numeric parts raise ValueError exactly as
        # the reference's unguarded int() does. keys.parse_tile_id is the
        # lenient variant that returns None for both.
        parts = tile_id.split("_")
        if len(parts) != 3:
            return None

        tile = cls()
        tile.tile_id = tile_id
        tile.zoom = int(parts[0])
        tile.row = int(parts[1])
        tile.column = int(parts[2])
        tile.latitude_north = _latitude_from_row(tile.row, tile.zoom)
        tile.latitude_south = _latitude_from_row(tile.row + 1, tile.zoom)
        tile.longitude_west = _longitude_from_column(tile.column, tile.zoom)
        tile.longitude_east = _longitude_from_column(tile.column + 1, tile.zoom)
        # Arithmetic-mean center, NOT the Mercator midpoint (reference
        # tile.py:51-52) — the cascade's re-binning depends on this.
        tile.center_latitude = (tile.latitude_north + tile.latitude_south) / 2.0
        tile.center_longitude = (tile.longitude_east + tile.longitude_west) / 2.0
        return tile

    @classmethod
    def decode_tile_id(cls, tile_id):
        parts = tile_id.split("_")
        if len(parts) != 3:
            return None
        return {
            "id": tile_id,
            "zoom": int(parts[0]),
            "row": int(parts[1]),
            "column": int(parts[2]),
        }

    @classmethod
    def tile_ids_for_all_zoom_levels(cls, tile_id):
        # Note: range excludes MIN_ZOOM, i.e. zooms 16..1 — preserved quirk
        # (reference tile.py:83, SURVEY.md §8.11).
        tile = cls.tile_from_tile_id(tile_id)
        return [
            cls.tile_id_from_lat_long(tile.center_latitude, tile.center_longitude, z)
            for z in range(cls.MAX_ZOOM, cls.MIN_ZOOM, -1)
        ]

    # -- pyramid navigation (reference tile.py:60-64,88-98) ----------------

    def parent_id(self):
        return Tile.tile_id_from_lat_long(
            self.center_latitude, self.center_longitude, self.zoom - 1
        )

    def parent(self):
        return Tile.tile_from_tile_id(self.parent_id())

    def children(self):
        lat_mid_n = (self.center_latitude + self.latitude_north) / 2
        lat_mid_s = (self.center_latitude + self.latitude_south) / 2
        lon_mid_e = (self.center_longitude + self.longitude_east) / 2
        lon_mid_w = (self.center_longitude + self.longitude_west) / 2
        z = self.zoom + 1
        return [
            Tile.tile_id_from_lat_long(lat_mid_n, lon_mid_e, z),
            Tile.tile_id_from_lat_long(lat_mid_n, lon_mid_w, z),
            Tile.tile_id_from_lat_long(lat_mid_s, lon_mid_e, z),
            Tile.tile_id_from_lat_long(lat_mid_s, lon_mid_w, z),
        ]

    def __repr__(self):
        return f"Tile({self.tile_id!r})"
