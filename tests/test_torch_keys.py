"""The port's tile keys (heatmap_tpu_torch.tilemath.keys) and host
projection (``mercator.project_points_np``) against the JAX package's:
packed keys, parent/child navigation, the string-id codec, and the
numpy projection bit-equal at every synopsis zoom, near row edges too."""

import math

import numpy as np
import pytest
import torch

from heatmap_tpu.tilemath import keys as jkeys
from heatmap_tpu.tilemath import mercator as jmercator
from heatmap_tpu_torch.tilemath import keys
from heatmap_tpu_torch.tilemath import mercator


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(0)
    zoom = rng.integers(0, 30, 400)
    row = rng.integers(0, 1 << 29, 400) % (1 << zoom)
    col = rng.integers(0, 1 << 29, 400) % (1 << zoom)
    got = keys.pack_key(zoom, row, col)
    want = np.asarray(jkeys.pack_key(zoom, row, col))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # Sort order is (zoom, row, col) lexicographic.
    order = np.lexsort((col, row, zoom))
    assert (np.diff(got.numpy()[order]) >= 0).all()
    for a, b in zip(keys.unpack_key(got), jkeys.unpack_key(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="zooms <= 29"):
        keys.pack_key(30, 0, 0)
    with pytest.raises(ValueError, match="zooms <= 29"):
        jkeys.pack_key(30, 0, 0)


@pytest.mark.parametrize("fn,args", [
    ("parent_rowcol", (np.arange(10), np.arange(10, 20))),
    ("rowcol_at_zoom", (np.arange(100, 110), np.arange(5, 15), 12, 7)),
    ("children_rowcol", (np.arange(4), np.arange(4, 8))),
])
def test_navigation_matches_jax(fn, args):
    got = getattr(keys, fn)(*args)
    want = getattr(jkeys, fn)(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_rowcol_at_zoom_only_coarsens():
    for mod in (keys, jkeys):
        with pytest.raises(ValueError, match="only coarsens"):
            mod.rowcol_at_zoom(1, 1, 5, 6)


@pytest.mark.parametrize("tile_id", ["10_340_511", "1_2", "a_b_c", "",
                                     "3_-1_4", "0_0_0", "1_2_3_4", "07_1_2"])
def test_parse_tile_id_matches_jax(tile_id):
    assert keys.parse_tile_id(tile_id) == jkeys.parse_tile_id(tile_id)


@pytest.mark.parametrize("lat,lon,zoom", [
    (51.5074, -0.1278, 10), (47.6, -122.3, 21), (0.0, 0.0, 0),
    (-33.86, 151.2, 15), (85.0, 179.999, 5)])
def test_scalar_ids_match_jax(lat, lon, zoom):
    got = keys.tile_id_from_lat_long(lat, lon, zoom)
    assert got == jkeys.tile_id_from_lat_long(lat, lon, zoom)
    assert keys.tile_id_string(*keys.parse_tile_id(got)) == got
    if (lat, lon, zoom) == (51.5074, -0.1278, 10):
        assert got == "10_340_511"


def test_tile_ids_to_arrays_matches_jax():
    ids = ["10_340_511", "bad", "3_1_2", "1_2", "5_31_0"]
    for a, b in zip(keys.tile_ids_to_arrays(ids),
                    jkeys.tile_ids_to_arrays(ids)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _row_edge_latitudes(zoom, n):
    """Latitudes within a few ulps of row edges at ``zoom``."""
    rows = np.random.default_rng(zoom).integers(1, (1 << zoom) - 1, n)
    out = []
    for r in rows.tolist():
        y = math.pi * (1 - 2 * r / (1 << zoom))
        lat = math.degrees(math.atan(math.sinh(y)))
        out += [lat, np.nextafter(lat, 90.0), np.nextafter(lat, -90.0)]
    return np.asarray(out)


@pytest.mark.parametrize("zoom", [4, 6, 8, 10, 12, 16, 21])
def test_project_points_np_bit_equal_to_jax(zoom):
    """The provisional overlay's host projection, as the JAX loop's,
    at every synopsis zoom and near row edges."""
    rng = np.random.default_rng(zoom)
    lat = np.concatenate([rng.uniform(-86, 86, 2000),
                          _row_edge_latitudes(zoom, 300),
                          [90.0, -90.0, np.nan, 85.0511, -85.0511]])
    lon = np.concatenate([rng.uniform(-180, 180, 2000),
                          rng.uniform(-180, 180, 900),
                          [0.0, 180.0, -180.0, np.nan, 179.9999]])
    got = mercator.project_points_np(lat, lon, zoom)
    want = jmercator.project_points_np(lat, lon, zoom)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
