"""The port's f64 projection and Morton codes against heatmap_tpu.tilemath
and the scalar oracle, on the CPU: tile assignments and codes must be
exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.tilemath import mercator as jmerc
from heatmap_tpu.tilemath import morton as jmorton
from heatmap_tpu_torch.tilemath import mercator as tmerc
from heatmap_tpu_torch.tilemath import morton as tmorton
import oracle


def _points(seed, n=4000):
    """Seeded points: a metro cluster, the whole world, and edge cases
    (poles, the Mercator edge, lon == +-180, NaN)."""
    rng = np.random.default_rng(seed)
    lat = np.concatenate([
        47.6 + rng.normal(0, 0.5, n // 2),
        rng.uniform(-90, 90, n // 2),
        [90.0, -90.0, 85.0511, -85.0511, 85.06, 0.0, 51.5074, np.nan],
    ])
    lon = np.concatenate([
        -122.3 + rng.normal(0, 0.7, n // 2),
        rng.uniform(-180, 180, n // 2),
        [0.0, 0.0, 180.0, -180.0, 10.0, 180.0, -0.1278, 0.0],
    ])
    return lat, lon


@pytest.mark.parametrize("zoom", [1, 10, 16, 21])
@pytest.mark.parametrize("seed", [0, 1])
def test_project_points_matches_jax(seed, zoom):
    lat, lon = _points(seed)
    jr, jc, jv = jmerc.project_points(jnp.asarray(lat), jnp.asarray(lon),
                                      zoom, dtype=jnp.float64)
    tr, tc, tv = tmerc.project_points(torch.as_tensor(lat),
                                      torch.as_tensor(lon), zoom)
    assert tr.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("zoom", [10, 21])
def test_project_points_np_matches_jax_np(zoom):
    lat, lon = _points(2)
    for got, want in zip(tmerc.project_points_np(lat, lon, zoom),
                         jmerc.project_points_np(lat, lon, zoom)):
        np.testing.assert_array_equal(got, want)


def test_projection_matches_oracle_and_validity():
    lat, lon = _points(3, n=600)
    zoom = 21
    row, col, valid = tmerc.project_points(torch.as_tensor(lat),
                                           torch.as_tensor(lon), zoom)
    for i in range(len(lat)):
        if not np.isfinite(lat[i]) or abs(lat[i]) >= 90:
            assert not bool(valid[i])
            continue
        r = oracle.row_from_latitude(float(lat[i]), zoom)
        c = oracle.column_from_longitude(float(lon[i]), zoom)
        ok = 0 <= r < (1 << zoom) and 0 <= c < (1 << zoom)
        assert bool(valid[i]) == ok, (lat[i], lon[i])
        if ok:
            assert (int(row[i]), int(col[i])) == (r, c)
    # lon == 180 gives column 2^zoom: out of range, masked not wrapped.
    _, _, v = tmerc.project_points(torch.tensor([0.0]), torch.tensor([180.0]), 3)
    assert not bool(v[0])
    # Beyond the Mercator edge: masked, no crash.
    _, _, v = tmerc.project_points(torch.tensor([85.06, -85.06]),
                                   torch.tensor([0.0, 0.0]), 10)
    assert not v.any()


def test_london_z10_spot_check():
    row, col, valid = tmerc.project_points(torch.tensor([51.5074]),
                                           torch.tensor([-0.1278]), 10)
    assert bool(valid[0])
    assert f"10_{int(row[0])}_{int(col[0])}" == "10_340_511"
    assert oracle.tile_id(51.5074, -0.1278, 10) == "10_340_511"


@pytest.mark.parametrize("zoom", [1, 12, 21, 29])
def test_morton_encode_decode_match_jax(zoom):
    rng = np.random.default_rng(zoom)
    row = rng.integers(0, 1 << zoom, 5000)
    col = rng.integers(0, 1 << zoom, 5000)
    want = np.asarray(jmorton.morton_encode(
        jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32),
        dtype=jnp.int64, zoom=zoom))
    got = tmorton.morton_encode(torch.as_tensor(row), torch.as_tensor(col),
                                zoom=zoom)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmorton.morton_encode_np(row, col),
                                  jmorton.morton_encode_np(row, col))
    for got_d, want_d in zip(tmorton.morton_decode_np(want),
                             jmorton._morton_decode_np_pure(want)):
        np.testing.assert_array_equal(got_d, want_d)
    r, c = tmorton.morton_decode_np(want)
    np.testing.assert_array_equal(r, row)
    np.testing.assert_array_equal(c, col)


def test_morton_zoom_limit_refused():
    with pytest.raises(ValueError, match="zooms <= 29"):
        tmorton.morton_encode(torch.zeros(1, dtype=torch.int64),
                              torch.zeros(1, dtype=torch.int64), zoom=30)
