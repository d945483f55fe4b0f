"""The port's library surface against the JAX package's: the reference's
scalar ``Tile`` class on ``tests/test_tile_compat.py``'s cases, the
vectorised Mercator functions on the same float64 inputs, the helpers
(``project_detail_codes``, ``emit_level_arrays``,
``device_put_columns``, ``masked_local_rc``, ``stage_block``,
``DispatchTimer``) and the names each package ``__init__`` exports."""

import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from heatmap_tpu.tilemath import Tile as JTile
from heatmap_tpu.tilemath import mercator as jmerc
from heatmap_tpu_torch import Tile
from heatmap_tpu_torch.tilemath import mercator as tmerc

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASE_IDS = ["10_397_163", "16_25000_11000", "0_0_0", "21_1048575_2097151",
            "12_1400_655", "5_10_20"]


def _rng_points(seed, n, lat=85.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-lat, lat, n), rng.uniform(-180, 180, n)


def test_classmethod_surface_equals_jax():
    for name in ("tile_id_from_lat_long", "tile_from_tile_id",
                 "tile_id_from_row_column", "decode_tile_id",
                 "tile_ids_for_all_zoom_levels", "row_from_latitude",
                 "column_from_longitude", "latitude_from_row",
                 "longitude_from_column", "parent_id", "parent",
                 "children"):
        assert callable(getattr(Tile, name)), name
    assert (Tile.MAX_ZOOM, Tile.MIN_ZOOM) == (JTile.MAX_ZOOM, JTile.MIN_ZOOM)
    public = {n for n in dir(JTile) if not n.startswith("_")}
    assert public == {n for n in dir(Tile) if not n.startswith("_")}


def test_tile_ids_equal_jax_and_oracle():
    lat, lon = _rng_points(0, 200)
    for la, lo in zip(lat.tolist(), lon.tolist()):
        for z in (0, 7, 16, 21):
            got = Tile.tile_id_from_lat_long(la, lo, z)
            assert got == JTile.tile_id_from_lat_long(la, lo, z)
            assert got == oracle.tile_id(la, lo, z)
    assert Tile.tile_id_from_lat_long(51.5074, -0.1278, 10) == "10_340_511"
    assert Tile.column_from_longitude(180.0, 4) == 16  # no wrap


@pytest.mark.parametrize("tile_id", CASE_IDS)
def test_tile_fields_parents_children_equal_jax(tile_id):
    got, want = Tile.tile_from_tile_id(tile_id), JTile.tile_from_tile_id(
        tile_id)
    for attr in ("tile_id", "zoom", "row", "column", "latitude_north",
                 "latitude_south", "longitude_west", "longitude_east",
                 "center_latitude", "center_longitude"):
        assert getattr(got, attr) == getattr(want, attr), attr
    exp_lat, exp_lon, _ = oracle.tile_center(tile_id)
    assert (got.center_latitude, got.center_longitude) == (exp_lat, exp_lon)
    assert repr(got) == f"Tile({tile_id!r})"
    assert Tile.decode_tile_id(tile_id) == JTile.decode_tile_id(tile_id)
    if got.zoom > 0:
        assert got.parent_id() == want.parent_id()
        assert got.parent().tile_id == want.parent().tile_id
    assert got.children() == want.children()
    if got.zoom <= Tile.MAX_ZOOM:
        assert (Tile.tile_ids_for_all_zoom_levels(tile_id)
                == JTile.tile_ids_for_all_zoom_levels(tile_id))


def test_tile_id_quirks_equal_jax():
    assert Tile.tile_from_tile_id("malformed") is None
    assert Tile.tile_from_tile_id("1_2") is None
    assert Tile.decode_tile_id("nope") is None
    for cls in (Tile, JTile):
        with pytest.raises(ValueError):
            cls.tile_from_tile_id("a_b_c")
    ids = Tile.tile_ids_for_all_zoom_levels("16_25000_11000")
    assert len(ids) == 16 and ids[-1].startswith("1_")
    assert Tile.tile_from_tile_id("10_397_163").parent_id() == "9_198_81"


def _both(name, *args):
    """The port's function on torch tensors and the JAX one on jnp
    arrays of the same float64 inputs, as numpy."""
    targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    got = getattr(tmerc, name)(*targs)
    want = getattr(jmerc, name)(*jargs)
    if isinstance(got, tuple):
        return ([g.numpy() for g in got], [np.asarray(w) for w in want])
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("zoom", [0, 6, 12, 16, 21])
def test_floored_rows_and_columns_equal_jax(zoom):
    lat, lon = _rng_points(zoom, 5000, lat=86.0)
    lat[:4] = [0.0, 85.0511287798066, -85.0511287798066, 47.6]
    lon[:4] = [-180.0, 180.0, 0.0, -122.3]
    for name, x in (("row_from_latitude", lat),
                    ("column_from_longitude", lon)):
        got, want = _both(name, x, zoom)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    got, want = _both("row_from_latitude", lat, zoom)
    assert got.tolist() == [oracle.row_from_latitude(x, zoom)
                            for x in lat.tolist()]


#: Latitudes and tile centers: torch's and XLA's float64 exp/atan round
#: apart by up to 2 ulps of the largest latitude (measured: 0-2), so the
#: bound is absolute; rtol=1e-15 does not hold near 0 degrees, where
#: e^n - e^-n cancels.
LAT_ATOL = 2 * float(np.spacing(90.0))


def test_mercator_xy_equal_jax():
    """x is plain arithmetic and bit-equal. y is within the per-lane
    bound that project_points' row-edge recheck uses: torch's float64
    tan and 1/cos carry ulp errors that tan + sec cancels at southern
    latitudes (measured up to 69 ulps of 1.0 at -86 degrees, where the
    JAX package's y equals CPython's); floored rows are exact anyway
    (the row test above)."""
    lat, lon = _rng_points(3, 20000, lat=86.0)
    got, want = _both("mercator_x", lon)
    np.testing.assert_array_equal(got, want)
    got, want = _both("mercator_y", lat)
    phi = lat * np.pi / 180.0
    t, s = np.tan(phi), 1.0 / np.cos(phi)
    u = t + s
    eps = float(np.spacing(1.0))
    bound = 16 * eps * ((np.abs(t) + np.abs(s)) / np.abs(u)
                        + np.abs(np.log(u)) + 2.0)
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("zoom", [1, 10, 21])
def test_inverse_and_centers_equal_jax(zoom):
    """Edge latitudes and centers through exp/atan agree within
    LAT_ATOL; longitudes are plain arithmetic and bit-equal."""
    rng = np.random.default_rng(zoom)
    rows = rng.integers(0, 1 << zoom, 3000).astype(np.float64)
    cols = rng.integers(0, 1 << zoom, 3000).astype(np.float64)
    got, want = _both("latitude_from_row", rows, zoom)
    np.testing.assert_allclose(got, want, rtol=0, atol=LAT_ATOL)
    got, want = _both("longitude_from_column", cols, zoom)
    np.testing.assert_array_equal(got, want)
    (glat, glon), (wlat, wlon) = _both("tile_center_latlon", rows, cols,
                                       zoom)
    np.testing.assert_allclose(glat, wlat, rtol=0, atol=LAT_ATOL)
    np.testing.assert_array_equal(glon, wlon)


def test_mercator_keeps_the_input_device_and_default_dtype():
    assert tmerc.default_float_dtype() == torch.float64
    x = torch.tensor([10.0, 20.0], dtype=torch.float32)
    assert tmerc.mercator_y(x).dtype == torch.float64
    assert tmerc.row_from_latitude([47.6], 12).device == torch.device("cpu")
    assert tmerc.row_from_latitude(x, 12, dtype=torch.float32).dtype == (
        torch.float32)


def test_project_detail_codes_equals_jax():
    from heatmap_tpu.pipeline.batch import project_detail_codes as jpdc
    from heatmap_tpu_torch.pipeline.batch import project_detail_codes

    lat, lon = _rng_points(5, 4000, lat=86.0)
    for zoom in (12, 21):
        want = jpdc(lat, lon, zoom, prefer_device=False)
        for prefer in (False, True):
            got = project_detail_codes(lat, lon, zoom, prefer_device=prefer,
                                       device="cpu")
            for g, w in zip(got, want):
                assert isinstance(g, np.ndarray)
                np.testing.assert_array_equal(g, np.asarray(w))


def test_emit_level_arrays_equals_jax():
    from heatmap_tpu.pipeline import cascade as jcascade
    from heatmap_tpu_torch.pipeline import cascade as tcascade

    rng = np.random.default_rng(9)
    codes = rng.integers(0, 1 << 24, 3000).astype(np.int64)
    slots = rng.integers(0, 6, 3000).astype(np.int32)
    names = {s: (["all", "user-1", "user-2"][s % 3],
                 ["alltime", "month"][s // 3]) for s in range(6)}
    for amplify in (False, True):
        kw = dict(detail_zoom=12, min_detail_zoom=6, result_delta=3,
                  amplify_all=amplify)
        got = tcascade.emit_level_arrays(
            tcascade.run_cascade(torch.as_tensor(codes),
                                 torch.as_tensor(slots),
                                 tcascade.CascadeConfig(**kw), n_slots=6),
            tcascade.CascadeConfig(**kw), names)
        want = jcascade.emit_level_arrays(
            jcascade.run_cascade(jnp.asarray(codes), jnp.asarray(slots),
                                 jcascade.CascadeConfig(**kw), n_slots=6),
            jcascade.CascadeConfig(**kw), names)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


def test_device_put_columns_moves_numeric_columns_only():
    from heatmap_tpu_torch.pipeline.feeder import device_put_columns

    cols = {"latitude": np.array([1.0, 2.0]), "longitude": np.array([3.0,
                                                                     4.0]),
            "value": np.array([1, 2], np.int32), "user_id": ["a", "b"],
            "timestamp": np.array([5, 6])}
    out = device_put_columns(cols, device="cpu")
    for name in ("latitude", "longitude", "value"):
        assert isinstance(out[name], torch.Tensor)
        assert out[name].device == torch.device("cpu")
        np.testing.assert_array_equal(out[name].numpy(), cols[name])
    assert out["user_id"] is cols["user_id"]
    assert out["timestamp"] is cols["timestamp"]
    assert isinstance(cols["latitude"], np.ndarray)  # input untouched
    out = device_put_columns(cols, device="cpu", columns=("latitude",))
    assert isinstance(out["longitude"], np.ndarray)


def test_masked_local_rc_equals_jax():
    from heatmap_tpu.ops.partitioned import masked_local_rc as jmlr
    from heatmap_tpu_torch.ops.partitioned import masked_local_rc

    rng = np.random.default_rng(4)
    for block_cells, side in ((1 << 16, 256), (1 << 8, 16)):
        stream = rng.integers(-block_cells, 4 * block_cells,
                              4096).astype(np.int32)
        good = rng.integers(0, 2, 4096).astype(np.int32)
        for start in (0, 1, 3):
            got = masked_local_rc(torch.tensor(start, dtype=torch.int32),
                                  torch.as_tensor(good),
                                  torch.as_tensor(stream), block_cells, side)
            want = jmlr(jnp.int32(start), jnp.asarray(good),
                        jnp.asarray(stream), block_cells, side)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stage_block_and_dispatch_timer():
    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.utils import trace

    x = torch.arange(3)
    assert trace.stage_block(x) is x
    trace.enable_stage_tracing(True)
    try:
        assert trace.stage_block(x) is x
    finally:
        trace.enable_stage_tracing(False)
    timer = obs.DispatchTimer("single")
    assert not timer.enabled
    timer.dispatched()
    assert timer.finished(items=5) is None
    obs.get_registry().reset()
    obs.enable_metrics(True)
    try:
        timer = obs.DispatchTimer("gspmd")
        timer.dispatched()
        host_s, device_s = timer.finished(items=5)
        assert host_s >= 0 and device_s >= 0
        assert obs.DISPATCH_OVERHEAD.samples()[("gspmd",)][2] == 1
        stages = obs.STAGE_SECONDS.samples()
        assert stages[("cascade.dispatch.host",)][2] == 1
        assert stages[("cascade.dispatch.device",)][2] == 1
    finally:
        obs.enable_metrics(False)
        obs.get_registry().reset()


#: Names a JAX ``__init__`` exports that the port leaves out on purpose,
#: each with its reason.
JAX_ONLY = {
    "jax_profile": "a jax.profiler capture; the port has torch_profile",
    "shard_map": "JAX's SPMD primitive; the port's mesh runs shard bodies "
                 "per shard (parallel/mesh.py)",
    "pltpu_vmem": "a Pallas TPU memory space; no CUDA counterpart",
    "haar2d_jax": "a jnp function; its torch twin is haar2d_torch",
    "grid_from_rows_jax": "a jnp function; its torch twin is "
                          "grid_from_rows_torch",
    "integral2d_jax": "a jnp function; its torch twin is integral2d_torch",
}

PACKAGES = ["", ".tilemath", ".ops", ".pipeline", ".obs", ".io",
            ".faults", ".delta", ".serve", ".parallel", ".ingest",
            ".writeplane", ".temporal", ".synopsis", ".analytics",
            ".tilefs", ".utils"]


def _exported(module, path):
    """A package's exports: its ``__all__``, else every name its
    ``__init__`` imports or defines at top level."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_package_exports_cover_jax(sub):
    jmod = importlib.import_module("heatmap_tpu" + sub)
    tmod = importlib.import_module("heatmap_tpu_torch" + sub)
    jpath = ROOT / ("heatmap_tpu" + sub).replace(".", "/") / "__init__.py"
    missing = sorted(n for n in _exported(jmod, jpath) - set(JAX_ONLY)
                     if not hasattr(tmod, n))
    assert not missing, missing
    tpath = ROOT / ("heatmap_tpu_torch" + sub).replace(".", "/") / (
        "__init__.py")
    for name in _exported(tmod, tpath):
        assert hasattr(tmod, name), name
    for name in JAX_ONLY:
        assert not hasattr(tmod, name), name
