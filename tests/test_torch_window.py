"""Window binning on the CPU: heatmap_tpu's ops and the port's on the same
seeded inputs. Windows, backend routing, the three binning backends
(the port's plain versions against the JAX scatter and the Pallas
kernels in interpret mode, with the small block and chunk sizes of
tests/test_partitioned.py), their refusals, the dense pyramid, the
Gaussian splat and the headline step. Counts and integer weights must
be equal; fractional float32 weights within ``rtol=1e-5`` (the JAX
package's "within f32 rounding"); the splat within ``rtol=1e-6``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from heatmap_tpu.ops import histogram as jh
from heatmap_tpu.ops import pallas_kernels as jpk
from heatmap_tpu.ops import partitioned as jpt
from heatmap_tpu.ops import pyramid as jpyr
from heatmap_tpu.ops import splat as jsplat
from heatmap_tpu_torch import bench as tbench
from heatmap_tpu_torch import interop
from heatmap_tpu_torch.ops import histogram as th
from heatmap_tpu_torch.ops import pallas_kernels as tpk
from heatmap_tpu_torch.ops import partitioned as tpt
from heatmap_tpu_torch.ops import pyramid as tpyr
from heatmap_tpu_torch.ops import splat as tsplat

#: A window for the whole-window kernel (6,144 cells) and one for the
#: partitioned path (81,920 cells, above PALLAS_AUTO_MAX_CELLS).
SMALL = jh.Window(zoom=12, row0=512, col0=256, height=64, width=96)
LARGE = jh.Window(zoom=12, row0=512, col0=256, height=256, width=320)
FRACTIONAL_RTOL = 1e-5


def _tw(window):
    """The port's Window with a JAX Window's fields."""
    return interop.window_from_fields(**dataclasses.asdict(window))


def _points(case, window, seed=0):
    """Seeded (row, col, valid) int32/int32/bool numpy arrays."""
    rng = np.random.default_rng(seed)
    h, w = window.height, window.width
    if case == "clustered":
        n = 1 << 13
        row = window.row0 + h // 3 + rng.integers(0, 12, n)
        col = window.col0 + w // 4 + rng.integers(0, 20, n)
        # A hot cell, and a sparse fringe partly outside the window.
        row[300:3300] = window.row0 + h // 3 + 5
        col[300:3300] = window.col0 + w // 4 + 7
        row[:300] = rng.integers(window.row0 - 50, window.row0 + h + 50, 300)
        col[:300] = rng.integers(window.col0 - 50, window.col0 + w + 50, 300)
    elif case == "uniform":
        n = 1 << 13
        row = rng.integers(window.row0, window.row0 + h, n)
        col = rng.integers(window.col0, window.col0 + w, n)
    elif case == "all_out":
        n = 700
        row = rng.integers(0, window.row0, n)
        col = rng.integers(0, 4096, n)
    elif case == "tiny":
        n = 5
        row = window.row0 + np.array([0, 0, h - 1, 3, h + 4])
        col = window.col0 + np.array([0, 0, w - 1, 2, 1])
    elif case == "empty":
        n = 0
        row = col = np.zeros(0, np.int64)
    else:
        raise AssertionError(case)
    valid = rng.random(n) < 0.9
    return row.astype(np.int32), col.astype(np.int32), valid


def _jax_bin(backend, row, col, window, weights=None, valid=None, **kw):
    args = (jnp.asarray(row), jnp.asarray(col), window)
    kwargs = {"weights": None if weights is None else jnp.asarray(weights),
              "valid": None if valid is None else jnp.asarray(valid)}
    if backend == "pallas":
        out = jpk.bin_rowcol_window_pallas(*args, **kwargs, interpret=True,
                                           chunk=kw.get("chunk", 128))
        dtype = jnp.int32 if weights is None else jnp.float32
        return np.asarray(out.astype(dtype))
    if backend == "partitioned":
        return np.asarray(jpt.bin_rowcol_window_partitioned(
            *args, **kwargs, interpret=True, block_cells=4096,
            chunk=kw.get("chunk", 256), streams=kw.get("streams", 8)))
    return np.asarray(jh.bin_rowcol_window(*args, **kwargs, backend="xla"))


def _port_bin(backend, row, col, window, weights=None, valid=None, **kw):
    tw = _tw(window)
    row, col = torch.as_tensor(row), torch.as_tensor(col)
    weights = None if weights is None else torch.as_tensor(weights)
    valid = None if valid is None else torch.as_tensor(valid)
    if backend == "partitioned":
        out = tpt.bin_rowcol_window_partitioned(
            row, col, tw, weights=weights, valid=valid,
            streams=kw.get("streams", 8))
    else:
        out = th.bin_rowcol_window(row, col, tw, weights=weights,
                                   valid=valid, backend=backend)
    return out.numpy()


def _window_for(backend):
    return LARGE if backend == "partitioned" else SMALL


# --- windows and routing -------------------------------------------------

BOUNDS = [
    ((45.0, 50.0), (-125.0, -119.0), 16, 8, 256),
    ((44.0, 51.0), (-127.0, -117.0), 15, 12, 256),
    ((47.6, 47.61), (-122.3, -122.29), 21, 0, 1),
    ((10.0, -10.0), (179.9, 170.0), 5, 2, 1),
    ((80.0, 89.0), (-180.0, 180.0), 3, 3, 8),
    ((-89.0, 89.0), (-10.0, 10.0), 2, 1, 3),
    ((0.0, 0.001), (0.0, 0.001), 0, 0, 1),
    ((1.0, 2.0), (3.0, 4.0), 4, 5, 1),
    ((86.0, 89.0), (0.0, 1.0), 8, 0, 1),
]


@pytest.mark.parametrize("lat,lon,zoom,align,pad", BOUNDS)
def test_window_from_bounds_matches_jax(lat, lon, zoom, align, pad):
    def call(mod):
        try:
            return dataclasses.asdict(mod.window_from_bounds(
                lat, lon, zoom, align_levels=align, pad_multiple=pad))
        except ValueError as e:
            return ("ValueError", str(e))

    assert call(th) == call(jh)


@pytest.mark.parametrize("fields", [
    dict(zoom=3, row0=-1, col0=0, height=2, width=2),
    dict(zoom=3, row0=0, col0=7, height=2, width=2),
    dict(zoom=3, row0=0, col0=0, height=0, width=2),
    dict(zoom=5, row0=4, col0=8, height=16, width=8),
])
def test_window_validation_matches_jax(fields):
    def make(cls):
        try:
            w = cls(**fields)
            return (w.shape, w.aligned_to(2), w.aligned_to(3))
        except ValueError as e:
            return ("ValueError", str(e))

    assert make(th.Window) == make(jh.Window)


@pytest.mark.parametrize("device,shape,want", [
    ("cpu", (16, 16), "xla"),
    ("cpu", (4096, 4096), "xla"),
    ("cuda", (16, 16), "pallas"),
    ("cuda", (256, 256), "pallas"),
    ("cuda", (256, 257), "partitioned"),
    ("cuda", (4096, 4096), "partitioned"),
])
def test_pick_backend_by_device_and_cells(device, shape, want):
    window = th.Window(zoom=12, row0=0, col0=0, height=shape[0],
                       width=shape[1])
    assert th._pick_backend("auto", window, device) == want
    for explicit in ("xla", "pallas", "partitioned"):
        assert th._pick_backend(explicit, window, device) == explicit
    if device == "cpu":
        # The JAX package also resolves "auto" to its scatter off the TPU.
        jw = jh.Window(**dataclasses.asdict(window))
        assert jh._pick_backend("auto", jw) == "xla"
    with pytest.raises(ValueError, match="unknown binning backend"):
        th._pick_backend("mxu", window, device)


# --- the three backends against the JAX package --------------------------

@pytest.mark.parametrize("case", ["clustered", "uniform", "all_out", "tiny",
                                  "empty"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "partitioned"])
def test_counts_match_jax(backend, case):
    """Counts, with a validity mask, bit-equal to the JAX backend of the
    same name (the Pallas kernels in interpret mode); "partitioned" on
    uniform points takes the JAX path's full-scatter fallback. The
    clustered case piles thousands of points onto hot cells, still far
    below 2^24 per cell, where the JAX kernels' f32 sums are exact."""
    window = _window_for(backend)
    row, col, valid = _points(case, window)
    want = _jax_bin(backend, row, col, window, valid=valid)
    got = _port_bin(backend, row, col, window, valid=valid)
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "clustered":
        assert want.max() > 1000


@pytest.mark.parametrize("kind", ["integer", "fractional"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "partitioned"])
def test_weights_match_jax(backend, kind):
    window = _window_for(backend)
    row, col, valid = _points("clustered", window, seed=3)
    rng = np.random.default_rng(4)
    if kind == "integer":
        w = rng.integers(0, 101, row.shape[0]).astype(np.float32)
    else:
        w = (rng.random(row.shape[0]) * 10).astype(np.float32)
    # NaN weights on dropped lanes must not reach the raster.
    w[~valid] = np.nan
    want = _jax_bin(backend, row, col, window, weights=w, valid=valid)
    got = _port_bin(backend, row, col, window, weights=w, valid=valid)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=FRACTIONAL_RTOL)


@pytest.mark.parametrize("streams", [1, 4, 8])
def test_partitioned_streams_match_jax(streams):
    row, col, valid = _points("clustered", LARGE, seed=5)
    want = _jax_bin("partitioned", row, col, LARGE, valid=valid,
                    streams=streams)
    got = _port_bin("partitioned", row, col, LARGE, valid=valid,
                    streams=streams)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [128, 256])
def test_pallas_chunks_match_jax(chunk):
    row, col, valid = _points("clustered", SMALL, seed=6)
    want = _jax_bin("pallas", row, col, SMALL, valid=valid, chunk=chunk)
    got = tpk.bin_rowcol_window_pallas(
        torch.as_tensor(row), torch.as_tensor(col), _tw(SMALL),
        valid=torch.as_tensor(valid), chunk=chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_counts_past_2_24_stay_exact():
    """Both kernel backends count in int32: one cell hit 2^24 + 3 times
    holds exactly that, where an f32 sum (the JAX kernels' accumulator)
    stops at 2^24. Below 2^24 per cell the two agree (the tests above)."""
    n = (1 << 24) + 3
    tw = _tw(SMALL)
    row = torch.full((n,), SMALL.row0 + 1, dtype=torch.int32)
    col = torch.full((n,), SMALL.col0 + 2, dtype=torch.int32)
    assert float(np.float32(n)) != n
    for out in (tpk.bin_rowcol_window_pallas(row, col, tw),
                tpt.bin_rowcol_window_partitioned(row, col, tw)):
        assert int(out[1, 2]) == n and int(out.sum()) == n


@pytest.mark.parametrize("window", [
    jh.Window(zoom=12, row0=0, col0=0, height=4096, width=4096),
    jh.Window(zoom=16, row0=0, col0=0, height=1792, width=1280),
    jh.Window(zoom=16, row0=0, col0=0, height=65536, width=65536),
    jh.Window(zoom=16, row0=0, col0=0, height=16384, width=65536),
    jh.Window(zoom=3, row0=0, col0=0, height=8, width=8),
])
@pytest.mark.parametrize("streams", [1, 8, 32])
def test_clamp_streams_matches_jax(window, streams):
    for block_cells in (4096, 1 << 16):
        assert tpt.clamp_streams(streams, _tw(window), block_cells) == \
            jpt.clamp_streams(streams, window, block_cells)


@pytest.mark.parametrize("bad", [1 << 13, 100, 1 << 10])
def test_block_cells_refusal_matches_jax(bad):
    row, col, _ = _points("tiny", LARGE)
    with pytest.raises(ValueError) as jerr:
        jpt.bin_rowcol_window_partitioned(
            jnp.asarray(row), jnp.asarray(col), LARGE, interpret=True,
            block_cells=bad)
    with pytest.raises(ValueError) as terr:
        tpt.bin_rowcol_window_partitioned(
            torch.as_tensor(row), torch.as_tensor(col), _tw(LARGE),
            block_cells=bad)
    assert str(terr.value) == str(jerr.value)


def test_int32_cell_id_refusal_matches_jax():
    huge = jh.Window(zoom=16, row0=0, col0=0, height=65536, width=32768)
    row = np.zeros(4, np.int32)
    with pytest.raises(ValueError) as jerr:
        jpt.bin_rowcol_window_partitioned(jnp.asarray(row), jnp.asarray(row),
                                          huge, interpret=True)
    for fn in (tpt.bin_rowcol_window_partitioned,
               tpk.bin_rowcol_window_pallas):
        with pytest.raises(ValueError) as terr:
            fn(torch.as_tensor(row), torch.as_tensor(row), _tw(huge))
        assert str(terr.value) == str(jerr.value)
        assert "int32 cell ids" in str(terr.value)


def test_bf16_weighted_refusal_matches_jax():
    row, col, _ = _points("tiny", SMALL)
    w = np.ones(row.shape[0], np.float32)
    with pytest.raises(ValueError) as jerr:
        jpk.bin_rowcol_window_pallas(
            jnp.asarray(row), jnp.asarray(col), SMALL, weights=jnp.asarray(w),
            interpret=True, onehot_dtype=jnp.bfloat16)
    with pytest.raises(ValueError) as terr:
        tpk.bin_rowcol_window_pallas(
            torch.as_tensor(row), torch.as_tensor(col), _tw(SMALL),
            weights=torch.as_tensor(w), onehot_dtype=torch.bfloat16)
    assert str(terr.value) == str(jerr.value)
    # Counts take any one-hot type, as in the JAX package.
    out = tpk.bin_rowcol_window_pallas(
        torch.as_tensor(row), torch.as_tensor(col), _tw(SMALL),
        onehot_dtype=torch.bfloat16)
    assert int(out.sum()) == 4


@pytest.mark.parametrize("kw,match", [
    ({"chunk": 0}, "chunk"),
    ({"bad_frac": 0}, "bad_frac"),
    ({"streams": 0}, "streams must be >= 1"),
])
def test_partitioned_argument_refusals(kw, match):
    row, col, _ = _points("tiny", LARGE)
    with pytest.raises(ValueError, match=match):
        tpt.bin_rowcol_window_partitioned(
            torch.as_tensor(row), torch.as_tensor(col), _tw(LARGE), **kw)


def test_kernel_wrappers_run_plain_on_cpu_and_count_no_launch():
    """A CPU tensor takes the plain version, and no kernel launch is
    counted for it."""
    before = (tpk.bin_rowcol_window_pallas.launches,
              tpt.bin_rowcol_window_partitioned.launches,
              tpt.bin_rowcol_window_partitioned.weighted_launches)
    row, col, valid = _points("clustered", LARGE)
    t = [torch.as_tensor(x) for x in (row, col, valid)]
    a = tpk.bin_rowcol_window_pallas(t[0], t[1], _tw(LARGE), valid=t[2])
    b = tpt.bin_rowcol_window_partitioned(t[0], t[1], _tw(LARGE), valid=t[2])
    c = tpt._plain(t[0], t[1], _tw(LARGE), None, t[2])
    assert torch.equal(a, b) and torch.equal(b, c)
    assert before == (tpk.bin_rowcol_window_pallas.launches,
                      tpt.bin_rowcol_window_partitioned.launches,
                      tpt.bin_rowcol_window_partitioned.weighted_launches)


@pytest.mark.parametrize("backend", ["xla", "pallas", "partitioned"])
def test_bin_points_window_matches_jax(backend):
    """Projection (f64) and binning together, against the JAX scatter."""
    rng = np.random.default_rng(8)
    n = 6000
    lat = 47.6 + rng.normal(0, 0.2, n)
    lon = -122.3 + rng.normal(0, 0.3, n)
    lat[:3] = [90.0, np.nan, -85.1]
    window = jh.window_from_bounds((47.0, 48.2), (-123.0, -121.6), 12,
                                   align_levels=2, pad_multiple=4)
    valid = rng.random(n) < 0.95
    want = np.asarray(jh.bin_points_window(
        jnp.asarray(lat), jnp.asarray(lon), window, valid=jnp.asarray(valid),
        proj_dtype=jnp.float64))
    got = th.bin_points_window(torch.as_tensor(lat), torch.as_tensor(lon),
                               _tw(window), valid=torch.as_tensor(valid),
                               backend=backend)
    np.testing.assert_array_equal(got.numpy(), want)
    if backend == "pallas":
        direct = tpk.bin_points_window_pallas(
            torch.as_tensor(lat), torch.as_tensor(lon), _tw(window),
            valid=torch.as_tensor(valid))
        np.testing.assert_array_equal(direct.numpy(), want)


# --- pyramid, splat, headline --------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_pyramid_from_raster_matches_jax(dtype):
    rng = np.random.default_rng(9)
    raster = rng.integers(0, 50, (64, 96)).astype(dtype)
    want = jpyr.pyramid_from_raster(jnp.asarray(raster), 5)
    got = tpyr.pyramid_from_raster(interop.raster_from_numpy(raster), 5)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == interop.raster_from_numpy(raster).dtype
        np.testing.assert_array_equal(interop.raster_to_numpy(g),
                                      np.asarray(w))
    batch = rng.integers(0, 9, (3, 4, 6)).astype(dtype)
    np.testing.assert_array_equal(
        tpyr.coarsen_raster(torch.as_tensor(batch)).numpy(),
        np.asarray(jpyr.coarsen_raster(jnp.asarray(batch))))


def test_coarsen_refusal_matches_jax():
    with pytest.raises(ValueError) as jerr:
        jpyr.coarsen_raster(jnp.zeros((4, 5), jnp.int32))
    with pytest.raises(ValueError) as terr:
        tpyr.coarsen_raster(torch.zeros((4, 5), dtype=torch.int32))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("size,sigma", [(9, None), (5, 1.0), (1, None),
                                        (7, 3.5)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_splat_raster_matches_jax(size, sigma, dtype):
    rng = np.random.default_rng(10)
    raster = (rng.random((40, 56)) < 0.1) * rng.integers(1, 30, (40, 56))
    raster = raster.astype(dtype)
    jk = jsplat.gaussian_kernel_1d(size, sigma)
    tk = tsplat.gaussian_kernel_1d(size, sigma)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    want = np.asarray(jsplat.splat_raster(jnp.asarray(raster), jk))
    got = tsplat.splat_raster(torch.as_tensor(raster), tk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,sigma", [(4, None), (0, None), (5, 0.0),
                                        (5, -1.0)])
def test_gaussian_kernel_refusals_match_jax(size, sigma):
    with pytest.raises(ValueError) as jerr:
        jsplat.gaussian_kernel_1d(size, sigma)
    with pytest.raises(ValueError) as terr:
        tsplat.gaussian_kernel_1d(size, sigma)
    assert str(terr.value) == str(jerr.value)


def test_bin_points_splat_matches_jax():
    rng = np.random.default_rng(11)
    lat = 47.6 + rng.normal(0, 0.1, 3000)
    lon = -122.3 + rng.normal(0, 0.1, 3000)
    w = rng.integers(0, 10, 3000).astype(np.float32)
    window = jh.window_from_bounds((47.3, 47.9), (-122.7, -121.9), 11)
    want = np.asarray(jsplat.bin_points_splat(
        jnp.asarray(lat), jnp.asarray(lon), window, weights=jnp.asarray(w),
        proj_dtype=jnp.float64))
    got = tsplat.bin_points_splat(torch.as_tensor(lat), torch.as_tensor(lon),
                                  _tw(window), weights=torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _jax_headline_step(lat, lon, window, levels, proj_dtype):
    """bench.py's jitted step, written out (it is local to bench.main)."""
    raster = jh.bin_points_window(jnp.asarray(lat), jnp.asarray(lon), window,
                                  proj_dtype=proj_dtype, backend="xla")
    out = [raster]
    r = raster
    for _ in range(levels):
        if r.shape[0] < 2 or r.shape[1] < 2:
            break
        h, w = r.shape
        r = r.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
        out.append(r)
    return [np.asarray(x) for x in out]


def test_headline_step_matches_jax():
    """The headline's inputs and step: same points, window and numpy
    baseline as bench.py; the f64 step's pyramid equals the JAX step's,
    through every backend; the f32 step moves only points next to a row
    edge, within the JAX package's z15 f32 mismatch rate."""
    n = 20_000
    lat, lon = tbench.make_points(n)
    jlat, jlon = jbench._make_points(n)
    np.testing.assert_array_equal(lat, jlat)
    np.testing.assert_array_equal(lon, jlon)
    jwindow = jh.window_from_bounds((44.0, 51.0), (-127.0, -117.0), zoom=15,
                                    align_levels=12, pad_multiple=256)
    window = tbench.headline_window()
    assert dataclasses.asdict(window) == dataclasses.asdict(jwindow)
    assert window.shape == (4096, 4096)
    want = _jax_headline_step(lat, lon, jwindow, 15, jnp.float64)
    assert len(want) == 13
    for backend in ("xla", "pallas", "partitioned"):
        total, got = tbench.step(torch.as_tensor(lat), torch.as_tensor(lon),
                                 window, 15, backend,
                                 proj_dtype=torch.float64)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        assert int(total) == int(want[-1].sum())
    want32 = _jax_headline_step(lat, lon, jwindow, 15, jnp.float32)
    total32, got32 = tbench.step(torch.as_tensor(lat), torch.as_tensor(lon),
                                 window, 15, "auto")
    assert int(total32) == int(want32[-1].sum())
    moved = np.abs(got32[0].numpy() - want32[0]).sum() / 2
    assert moved < 0.15 * n
    lat64, lon64 = lat.astype(np.float64), lon.astype(np.float64)
    assert tbench.numpy_baseline(lat64, lon64, window, 15) == \
        jbench._numpy_baseline(lat64, lon64, jwindow, 15)


def test_interop_window_and_rasters():
    w = interop.window_from_fields(**dataclasses.asdict(LARGE))
    assert isinstance(w, th.Window)
    assert dataclasses.asdict(w) == dataclasses.asdict(LARGE)
    raster = np.asarray(jh.bin_rowcol_window(
        jnp.asarray([600, 600, 601]), jnp.asarray([300, 300, 301]), LARGE))
    t = interop.raster_from_numpy(raster)
    assert t.dtype == torch.int32 and t.shape == raster.shape
    back = interop.raster_to_numpy(t)
    np.testing.assert_array_equal(back, raster)
    assert back.dtype == raster.dtype
