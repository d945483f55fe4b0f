"""The port's range-query engine (heatmap_tpu_torch.analytics.query) and
integral read side (``IntegralPair``, ``load_integrals``) against the
JAX package's: the same answers on the integral fast paths (dense
window and block descent) and on the exact row fall-through, and the
same one-line errors."""

import numpy as np
import pytest

from heatmap_tpu.analytics import integral as jintegral
from heatmap_tpu.analytics import query as jquery
from heatmap_tpu.serve.store import Level as JLevel
from heatmap_tpu_torch.analytics import integral, query
from heatmap_tpu_torch.serve.store import Level

ZOOM = 7


def _grid(seed, density):
    rng = np.random.default_rng(seed)
    n = 1 << ZOOM
    grid = np.zeros((n, n))
    m = rng.random((n, n)) < density
    grid[m] = rng.integers(1, 40, int(m.sum()))
    return grid


def _pairs(seed, density):
    grid = _grid(seed, density)
    r, c = np.nonzero(grid)
    sat, cnt = integral.build_pair(r, c, grid[r, c], ZOOM)
    jsat, jcnt = jintegral.build_pair(r, c, grid[r, c], ZOOM)
    np.testing.assert_array_equal(sat, jsat)
    np.testing.assert_array_equal(cnt, jcnt)
    tp = integral.IntegralPair("all", "alltime", ZOOM, sat, cnt)
    jp = jintegral.IntegralPair("all", "alltime", ZOOM, sat, cnt)
    from heatmap_tpu_torch.tilemath.morton import morton_encode_np

    codes = morton_encode_np(r.astype(np.int64), c.astype(np.int64))
    return tp, jp, Level(ZOOM, codes, grid[r, c]), JLevel(ZOOM, codes,
                                                          grid[r, c])


RECTS = [(0, 0, 127, 127), (3, 5, 60, 90), (10, 10, 10, 10),
         (100, 0, 127, 31), (0, 64, 127, 64)]


@pytest.mark.parametrize("seed,density", [(0, 0.3), (1, 0.01), (2, 0.0)])
@pytest.mark.parametrize("sparsity", [query.DESCENT_SPARSITY, 0])
def test_integral_paths_match_jax(seed, density, sparsity):
    tp, jp, _, _ = _pairs(seed, density)
    for rect in RECTS:
        assert query.range_sum(tp, rect) == jquery.range_sum(jp, rect)
        assert tp.cell_count(*rect) == jp.cell_count(*rect)
        for k in (1, 5, 50):
            assert (query.top_k_hotspots(tp, rect, k, sparsity=sparsity)
                    == jquery.top_k_hotspots(jp, rect, k,
                                             sparsity=sparsity))
        for q in (0.0, 0.25, 0.5, 0.99, 1.0):
            assert (query.quantile(tp, rect, q, sparsity=sparsity)
                    == jquery.quantile(jp, rect, q, sparsity=sparsity))


@pytest.mark.parametrize("seed,density", [(3, 0.2), (4, 0.02)])
def test_row_fallthrough_matches_jax(seed, density):
    _, _, lvl, jlvl = _pairs(seed, density)
    for rect in RECTS:
        for a, b in zip(query.level_cells(lvl, rect),
                        jquery.level_cells(jlvl, rect)):
            np.testing.assert_array_equal(a, b)
        assert query.range_sum_rows(lvl, rect) == jquery.range_sum_rows(
            jlvl, rect)
        assert query.top_k_rows(lvl, rect, 7) == jquery.top_k_rows(
            jlvl, rect, 7)
        for q in (0.1, 0.5, 0.9):
            assert (query.quantile_rows(lvl, rect, q)
                    == jquery.quantile_rows(jlvl, rect, q))


def test_with_extras_and_grid_roundtrip_match_jax():
    tp, jp, _, _ = _pairs(5, 0.1)
    rng = np.random.default_rng(5)
    r, c = rng.integers(0, 128, 50), rng.integers(0, 128, 50)
    v = rng.integers(-3, 9, 50).astype(np.float64)
    a, b = tp.with_extras(r, c, v), jp.with_extras(r, c, v)
    np.testing.assert_array_equal(a.sat, b.sat)
    np.testing.assert_array_equal(a.cnt, b.cnt)
    np.testing.assert_array_equal(tp.grid(), jp.grid())


@pytest.mark.parametrize("text,zoom", [
    ("0,0,3,3", 2), ("1,2,1,2", 5), ("0,0,4,0", 2), ("3,0,1,1", 4),
    ("a,b,c,d", 3), ("1,2,3", 3), ("", 1)])
def test_parse_bbox_matches_jax(text, zoom):
    try:
        want = jquery.parse_bbox(text, zoom)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            query.parse_bbox(text, zoom)
        assert str(got.value) == str(e)
    else:
        assert query.parse_bbox(text, zoom) == want


@pytest.mark.parametrize("op", ["sum", "topk", "quantile", "topk_growth",
                                "median"])
def test_validate_op_matches_jax(op):
    try:
        want = jquery.validate_op(op)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            query.validate_op(op)
        assert str(got.value) == str(e)
    else:
        assert query.validate_op(op) == want


def test_load_integrals_reads_both_writers(tmp_path):
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.io.sinks import LevelArraysSink
    from heatmap_tpu_torch.pipeline import batch

    with open_sink(f"arrays:{tmp_path}") as sink:
        batch.run_job(open_source("synthetic:1500:3"), sink,
                      batch.BatchJobConfig(detail_zoom=9,
                                           min_detail_zoom=4),
                      device="cpu")
    levels = LevelArraysSink.load(str(tmp_path))
    integral.write_integrals(str(tmp_path), levels)
    (tmp_path / "integral-z99.npz").write_bytes(b"torn")
    got = integral.load_integrals(str(tmp_path))
    want = jintegral.load_integrals(str(tmp_path))
    assert sorted(got) == sorted(want) and got
    for z in got:
        for a, b in zip(got[z], want[z]):
            assert (a.user, a.timespan, a.zoom, a.n) == (
                b.user, b.timespan, b.zoom, b.n)
            np.testing.assert_array_equal(a.sat, b.sat)
            np.testing.assert_array_equal(a.cnt, b.cnt)
    assert integral.load_integrals(str(tmp_path / "missing")) == {}
