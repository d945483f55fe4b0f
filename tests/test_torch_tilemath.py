"""The port's projection and Morton codes against heatmap_tpu.tilemath
and the scalar oracle, on the CPU: f64 tile assignments and codes must be
exactly equal, including at z21 row edges, where torch's vectorised
``log``/``tan``/``cos`` round differently from libm and the port
re-derives the rows on the host; f32 rows are held to the JAX package's
documented f32 mismatch rates. The fused CUDA projection's host side
(the flagged lanes' host rows, the overflow re-run, its spans and
counts) runs here on a numpy stand-in for the kernel's outputs; the
kernel itself runs only on the card (tests/test_torch_project_card.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.tilemath import mercator as jmerc
from heatmap_tpu.tilemath import morton as jmorton
from heatmap_tpu_torch import kernel_cases as kc
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
                                dtype=torch.int64, zoom=zoom)
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
                              torch.zeros(1, dtype=torch.int64),
                              dtype=torch.int64, zoom=30)


def _near_edge_latitudes():
    """chip_smoke.py's 700,000 latitudes: 100,000 z21 row edges and the
    three doubles on either side of each."""
    return kc.row_edge_latitudes()


def test_project_points_exact_at_z21_row_edges():
    """The repaired fault: without the host recheck, torch's f64 rows
    differed from CPython math on 1,214 of these latitudes."""
    lat = _near_edge_latitudes()
    lon = np.linspace(-179.0, 179.0, lat.shape[0])
    want = np.array([oracle.row_from_latitude(float(x), 21) for x in lat])
    before = tmerc.project_points.rechecked
    row, col, valid = tmerc.project_points(torch.as_tensor(lat),
                                           torch.as_tensor(lon), 21)
    assert tmerc.project_points.rechecked - before == lat.shape[0]
    assert valid.all()
    np.testing.assert_array_equal(row.numpy(), want)
    jr, jc, jv = jmerc.project_points(jnp.asarray(lat), jnp.asarray(lon), 21,
                                      dtype=jnp.float64)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))


@pytest.mark.parametrize("which", ["near_edges", "uniform", "south"])
def test_row_edge_margin_covers_torch_libm_gap(which):
    """The margin's unscaled bound holds for torch's functions against
    CPython's libm, so the safety factor is spare."""
    rng = np.random.default_rng(2)
    if which == "near_edges":
        lat = _near_edge_latitudes()[::7]
    elif which == "uniform":
        lat = rng.uniform(-85.0, 85.0, 100_000)
    else:
        lat = rng.uniform(-85.05, -80.0, 100_000)
    n = float(1 << 21)
    t_lat = torch.as_tensor(lat)
    phi = t_lat * math.pi / 180.0
    t, s = torch.tan(phi), 1.0 / torch.cos(phi)
    u = t + s
    log_u = torch.log(u)
    ny = ((1.0 - log_u / math.pi) / 2.0 * n).numpy()
    host = np.array([(1 - math.log(math.tan(x * math.pi / 180)
                                   + 1 / math.cos(x * math.pi / 180))
                      / math.pi) / 2 * n for x in lat])
    bound = (tmerc._row_edge_margin(t, s, u, log_u, n).numpy()
             / tmerc._EDGE_MARGIN_FACTOR)
    assert (np.abs(ny - host) <= bound).all()


def test_synthetic_points_rarely_rechecked():
    from heatmap_tpu_torch.io import SyntheticSource

    b = next(SyntheticSource(n=200_000, seed=0).batches(200_000))
    before = tmerc.project_points.rechecked
    tmerc.project_points(torch.as_tensor(b["latitude"]),
                         torch.as_tensor(b["longitude"]), 21)
    assert tmerc.project_points.rechecked - before <= 5


@pytest.mark.parametrize("zoom,max_rate", [(5, 2e-4), (10, 7e-3), (15, 0.15)])
def test_f32_projection_within_jax_rates(zoom, max_rate):
    """tests/test_mercator.py's f32 contract: row mismatches against f64
    below its thresholds, and off by one row only."""
    rng = np.random.default_rng(7)
    lat = rng.uniform(-85.0, 85.0, 50_000)
    lon = rng.uniform(-180.0, 179.9999, 50_000)
    r32, _, v32 = tmerc.project_points(torch.as_tensor(lat),
                                       torch.as_tensor(lon), zoom,
                                       dtype=torch.float32)
    r64, _, v64 = tmerc.project_points(torch.as_tensor(lat),
                                       torch.as_tensor(lon), zoom)
    both = (v32 & v64).numpy()
    r32, r64 = r32.numpy()[both], r64.numpy()[both]
    assert both.mean() > 0.99
    assert np.mean(r32 != r64) < max_rate
    diff = np.abs(r32.astype(np.int64) - r64)
    assert diff.max(initial=0) <= 1


def test_project_points_dtype_refusal():
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        tmerc.project_points(torch.zeros(2), torch.zeros(2), 3,
                             dtype=torch.float16)


# ---- the fused kernel's host side, on a numpy stand-in ---------------------

def _stand_in(calls):
    """A stand-in for ``mercator._launch`` on the CPU: the kernel's
    outputs computed from the plain version's float64 chain (rows,
    margin and columns as ``_floored_rows`` and ``_project_plain`` compute
    them) and laid out as the kernel lays them out: flagged lanes with
    row 0 and their column's own validity, their indices in a shuffled
    list cut at ``capacity`` and padded with garbage, and the full count.
    Each call's capacity is appended to ``calls``."""
    def launch(lat, lon, zoom, capacity):
        calls.append(capacity)
        n = float(1 << zoom)
        phi = lat * math.pi / 180.0
        t = torch.tan(phi)
        s = 1.0 / torch.cos(phi)
        u = t + s
        log_u = torch.log(u)
        ny = ((1.0 - log_u / math.pi) / 2.0 * n)
        margin = tmerc._row_edge_margin(t, s, u, log_u, n).numpy()
        ny = ny.numpy()
        frow = np.floor(ny)
        fcol = torch.floor((lon + 180.0) / 360.0 * n).numpy()
        with np.errstate(invalid="ignore"):
            near = np.isfinite(ny) & ~(np.abs(ny - np.round(ny)) > margin)
            col_ok = (fcol >= 0) & (fcol < n)
            row_ok = (frow >= 0) & (frow < n)
        valid = col_ok & (near | row_ok)
        row = np.where(valid & ~near, frow, 0).astype(np.int32)
        col = np.where(valid, fcol, 0).astype(np.int32)
        idx = np.random.default_rng(len(calls)).permutation(
            np.flatnonzero(near))
        flagged = np.full(capacity, -7, np.int64)
        flagged[:min(capacity, idx.size)] = idx[:capacity]
        return (torch.from_numpy(row), torch.from_numpy(col),
                torch.from_numpy(valid), torch.tensor([idx.size]),
                torch.from_numpy(flagged))
    return launch


@pytest.mark.parametrize("capacity", [8, tmerc.FLAGGED_CAPACITY])
@pytest.mark.parametrize("case", kc.PROJECTION_CASES)
def test_fused_host_side_matches_plain(monkeypatch, case, capacity):
    """The flagged lanes' host rows and the re-run on an overflowing list
    give the plain version's rows, columns, validity and rechecked
    count."""
    lat, lon, zoom = kc.projection_case(case)
    lat, lon = torch.as_tensor(lat), torch.as_tensor(lon)
    before = tmerc.project_points.rechecked
    want = tmerc._project_plain(lat, lon, zoom)
    k = tmerc.project_points.rechecked - before
    calls = []
    monkeypatch.setattr(tmerc, "_launch", _stand_in(calls))
    monkeypatch.setattr(tmerc, "FLAGGED_CAPACITY", capacity)
    before = tmerc.project_points.rechecked
    got = tmerc._project_fused(lat, lon, zoom)
    assert tmerc.project_points.rechecked - before == k
    assert calls == ([capacity, k] if k > capacity else [capacity])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _held_to_flat(monkeypatch, lat, lon, zoom):
    """Project a 2-D grid with flagged lanes by the plain version and by
    the fused host side on the stand-in: both give the grid's shape, and
    equal the flat projection of its lanes in order."""
    monkeypatch.setattr(tmerc, "_launch", _stand_in([]))
    before = tmerc.project_points.rechecked
    want = tmerc._project_plain(lat, lon, zoom)
    assert tmerc.project_points.rechecked > before
    got = tmerc._project_fused(lat, lon, zoom)
    lat, lon = torch.broadcast_tensors(lat, lon)
    flat = tmerc._project_plain(lat.reshape(-1), lon.reshape(-1), zoom)
    for g, w, f in zip(got, want, flat):
        assert g.shape == w.shape == lat.shape
        assert torch.equal(g, w)
        assert torch.equal(w.reshape(-1), f)


def test_fused_keeps_the_broadcast_shape(monkeypatch):
    """A 2-D grid of latitudes (with flagged lanes) against a row of
    longitudes: both paths give the broadcast shape, and the plain
    version's rechecked rows land on their own lanes."""
    lat, lon, zoom = kc.projection_case("mercator_edge")
    _held_to_flat(monkeypatch, torch.as_tensor(lat).reshape(-1, 8),
                  torch.as_tensor(lon[:8]), zoom)


def test_transposed_grid_rechecks_its_own_lanes(monkeypatch):
    """A transposed (non-contiguous) grid, whose plain rows keep its
    strides: the host rows still land on their own lanes."""
    lat, lon, zoom = kc.projection_case("mercator_edge")
    lat = torch.as_tensor(lat).reshape(8, -1).T
    assert not lat.is_contiguous()
    _held_to_flat(monkeypatch, lat, torch.as_tensor(lon).reshape(8, -1).T,
                  zoom)


def test_host_lanes_take_the_reference_rows():
    """Rows from CPython's math; a lane is valid only where both its host
    row and its column are, and invalid lanes come out as (0, 0)."""
    zoom = 21
    lat = [kc.row_edge_latitudes()[0], 85.0511, -90.0, 10.0, 47.6]
    col = np.array([5, 7, 9, 0, 3])
    col_ok = np.array([True, True, True, False, True])
    row, c, valid = tmerc._host_lanes(lat, col, col_ok, zoom)
    want = [oracle.row_from_latitude(x, zoom) for x in (lat[0], lat[1])]
    assert row.dtype == np.int32 and c.dtype == np.int32
    np.testing.assert_array_equal(valid, [True, True, False, False, True])
    np.testing.assert_array_equal(row[:2], want)
    np.testing.assert_array_equal(c, [5, 7, 0, 0, 3])
    assert row[2] == row[3] == 0
    assert row[4] == oracle.row_from_latitude(47.6, zoom)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_projection_takes_the_plain_version(monkeypatch, dtype):
    def refuse(*args):
        raise AssertionError("the fused kernel launched on the CPU")

    monkeypatch.setattr(tmerc, "_launch", refuse)
    launches = tmerc.project_points.fused_launches
    lat, lon = _points(3, n=400)
    got = tmerc.project_points(torch.as_tensor(lat), torch.as_tensor(lon),
                               16, dtype=dtype)
    want = tmerc._project_plain(torch.as_tensor(lat, dtype=dtype),
                                torch.as_tensor(lon, dtype=dtype), 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tmerc.project_points.fused_launches == launches


def test_fused_spans_open_rows_and_recheck_only(monkeypatch):
    """On the kernel's path the launch sits in ``project.rows`` and the
    count's read and host rows in ``project.recheck`` (items: the lanes
    rechecked); ``project.cols`` opens on the plain path only."""
    from heatmap_tpu_torch.utils import trace as ttrace

    lat, lon, zoom = kc.projection_case("mercator_edge")
    monkeypatch.setattr(tmerc, "_launch", _stand_in([]))
    ttrace.enable_stage_tracing(True)
    try:
        ttrace.get_tracer().reset()
        before = tmerc.project_points.rechecked
        tmerc._project_fused(torch.as_tensor(lat), torch.as_tensor(lon),
                             zoom)
        report = ttrace.get_tracer().report()
    finally:
        ttrace.enable_stage_tracing(False)
        ttrace.get_tracer().reset()
    assert {"project.rows", "project.recheck"} <= set(report)
    assert "project.cols" not in report
    k = tmerc.project_points.rechecked - before
    assert k > 0 and report["project.recheck"]["items"] == k
    assert report["project.rows"]["items"] == lat.shape[0]


def test_fused_launch_refuses_what_the_kernel_cannot_take():
    """The launcher checks dtype, shape, contiguity and device before it
    hands pointers to the kernel (here on the CPU, which it refuses)."""
    lat = torch.zeros(8, dtype=torch.float64)
    for a, b in [(lat, lat[:4]), (lat.float(), lat.float()),
                 (lat[::2], lat[::2]),
                 (lat.reshape(2, 4), lat.reshape(2, 4)), (lat, lat)]:
        with pytest.raises(ValueError, match="flat contiguous float64"):
            tmerc._launch(a, b, 10, 16)
