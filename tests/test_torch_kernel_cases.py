"""The edge cases of the segment-reduce and window-binning kernels
(``heatmap_tpu_torch.kernel_cases``, the inputs ``chip_smoke.py`` runs on
the card) through the port's plain versions on the CPU and through the
JAX package: bit-equal for counts and integer weights, fractional
weights within ``rtol=1e-4`` (float sums in another order). Also the
host-side planning of the kernels: tile counts and status words; the
sub-block grid of windows with ragged edges, chunking, work items and
the one scratch allocation of the bucketed passes, checked by a numpy
model of those passes (counts and weights) that must bin every case as
the JAX package does; and the histogram's bands and grid, checked by a
numpy model of the banded build. The projection cases through the
port's projection on the CPU (its plain version) against the JAX
package's float64 projection and the reference's scalar formula: rows,
columns and validity exactly equal.

The CUDA kernels run only on the card.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.ops import histogram as jh
from heatmap_tpu.ops import pallas_kernels as jpk
from heatmap_tpu.ops import partitioned as jpt
from heatmap_tpu.ops import sparse_partitioned as jsp
from heatmap_tpu.ops.sparse import aggregate_sorted_keys as j_agg
from heatmap_tpu.tilemath import mercator as jmerc
from heatmap_tpu_torch import interop
from heatmap_tpu_torch import kernel_cases as kc
from heatmap_tpu_torch.ops import pallas_kernels as tpk
from heatmap_tpu_torch.ops import partitioned as tpt
from heatmap_tpu_torch.ops import sparse_partitioned as tsp
from heatmap_tpu_torch.tilemath import mercator as tmerc
import oracle

SENTINEL = kc.SENTINEL
TILE = tsp.TILE_KEYS
BOUND = 100
#: The JAX kernel's exactness slab, small so interpret mode stays quick
#: (as in tests/test_torch_segment.py).
SLAB = 8192
#: Fractional float32 weights sum in another order in each package.
FRACTIONAL_RTOL = 1e-4


def _assert_same(got, want, capacity):
    gu, gs, gn = (np.asarray(x) for x in got)
    wu, ws, wn = (np.asarray(x) for x in want)
    assert int(gn) == int(wn)
    assert gu.shape == (capacity,) and gs.shape == (capacity,)
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(gs.astype(ws.dtype), ws)


def _port(keys, capacity, shift=0, weights=None):
    return tsp.aggregate_sorted_keys_partitioned(
        torch.as_tensor(keys), capacity, sentinel=SENTINEL >> shift,
        shift=shift,
        sorted_weights=None if weights is None else torch.as_tensor(weights),
        weight_bound=None if weights is None else BOUND)


def _jax_scatter(keys, capacity, shift=0, weights=None):
    w = (jnp.ones(len(keys), jnp.int32) if weights is None
         else jnp.asarray(weights))
    return j_agg(jnp.asarray(np.asarray(keys) >> shift), w, capacity,
                 sentinel=SENTINEL >> shift)


# --- segment reduce -------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", kc.SEGMENT_CASES)
def test_segment_cases_match_jax_scatter(case, weighted):
    keys, capacity = kc.segment_case(case)
    w = kc.segment_weights(keys, BOUND) if weighted else None
    got = _port(keys, capacity, weights=w)
    _assert_same(got, _jax_scatter(keys, capacity, weights=w), capacity)
    assert got[1].dtype == (torch.float64 if weighted else torch.int32)


@pytest.mark.parametrize("shift", [s for s in kc.SEGMENT_SHIFTS if s])
@pytest.mark.parametrize("case", ["run_over_three_tiles",
                                  "sentinel_tail_mid_tile", "many_tiles"])
def test_segment_shifts_match_jax(case, shift):
    keys, capacity = kc.segment_case(case)
    _assert_same(_port(keys, capacity, shift), _jax_scatter(
        keys, capacity, shift), capacity)


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_segment_capacity_around_tile_edge(delta):
    """The capacity cut one segment before, at and after the last
    segment that ends on the first tile edge: n_unique still counts all
    segments (the overflow signal)."""
    keys, capacity = kc.segment_case("capacity_at_tile_edge")
    capacity += delta
    got = _port(keys, capacity)
    _assert_same(got, _jax_scatter(keys, capacity), capacity)
    assert int(got[2]) > capacity


@pytest.mark.parametrize("case", ["below_one_tile", "one_key",
                                  "all_sentinel", "sentinel_tail_at_tile_edge"])
def test_segment_cases_match_jax_interpret(case):
    """The JAX Pallas kernel in interpret mode on the same cases."""
    keys, capacity = kc.segment_case(case)
    want = jsp.aggregate_sorted_keys_partitioned(
        jnp.asarray(keys), capacity, interpret=True, slab=SLAB)
    _assert_same(_port(keys, capacity), want, capacity)


@pytest.mark.parametrize("at", [TILE - 1, TILE, -1])
def test_segment_poison_at_tile_edges(at):
    """A bad weight on the lane before a tile edge, on the edge, or on
    the last real lane poisons n_unique; the same on a sentinel lane
    does not."""
    keys, capacity = kc.segment_case("sentinel_tail_mid_tile")
    w = kc.segment_weights(keys, BOUND)
    real = int((keys != SENTINEL).sum())
    lane = real - 1 if at == -1 else at
    bad = w.copy()
    bad[lane] = 2.5
    assert int(_port(keys, capacity, weights=bad)[2]) > capacity
    on_sentinel = w.copy()
    on_sentinel[real] = float("nan")
    _assert_same(_port(keys, capacity, weights=on_sentinel),
                 _jax_scatter(keys, capacity, weights=w), capacity)


@pytest.mark.parametrize("n,tiles", [(1, 1), (TILE, 1), (TILE + 1, 2),
                                     (7_601_050, 3712)])
def test_segment_status_words(n, tiles):
    """One tile counter plus one look-back status word per tile."""
    assert tsp.status_words(n) == 1 + tiles


def test_segment_cases_place_runs_on_tile_edges():
    """The generator builds what the case names say."""
    keys, _ = kc.segment_case("run_over_three_tiles")
    assert keys[TILE // 2] == keys[2 * TILE] != keys[TILE // 2 - 1]
    keys, capacity = kc.segment_case("capacity_at_tile_edge")
    assert keys[TILE - 1] != keys[TILE]
    assert len(np.unique(keys[:TILE])) == capacity
    keys, _ = kc.segment_case("sentinel_tail_at_tile_edge")
    assert keys[2 * TILE - 1] != SENTINEL and keys[2 * TILE] == SENTINEL
    keys, _ = kc.segment_case("sentinel_tail_mid_tile")
    assert (keys == SENTINEL).argmax() % TILE != 0
    keys, _ = kc.segment_case("many_tiles")
    assert keys.size > 10 * TILE and np.all(np.diff(keys) >= 0)


# --- partitioned counts ---------------------------------------------------

def _windows(fields):
    return jh.Window(**fields), interop.window_from_fields(**fields)


def _port_counts(row, col, window, valid):
    return tpt.bin_rowcol_window_partitioned(
        torch.as_tensor(row), torch.as_tensor(col), window,
        valid=torch.as_tensor(valid)).numpy()


def _model_bucketed(row, col, window, valid, plan, weights=None):
    """The bucketed passes in numpy, on ``plan``'s geometry: buckets by
    sub-block, chunks and groups of passes 1 and 3, work items of pass
    4, and each item's local cells (counts, or the kept points' weights
    carried beside them) flushed back into the window."""
    n = row.shape[0]
    r = row.astype(np.int64) - window.row0
    c = col.astype(np.int64) - window.col0
    ok = ((r >= 0) & (r < window.height) & (c >= 0) & (c < window.width)
          & valid)
    side = tpt.SUB_SIDE
    b = (r // side) * plan.sub_cols + c // side
    local = (r % side) * side + c % side
    assert np.all(np.arange(n) // plan.per_chunk < plan.chunks)
    assert np.all(b[ok] // plan.group_buckets < plan.groups)
    assert np.all((b[ok] >= 0) & (b[ok] < plan.buckets))
    counts = np.bincount(b[ok], minlength=plan.buckets)
    items = -(-counts // tpt.ITEM_POINTS)
    assert items.sum() <= plan.items_max
    out = np.zeros((window.height, window.width),
                   np.int32 if weights is None else np.float32)
    order = np.argsort(b[ok], kind="stable")
    bk, lk = b[ok][order], local[ok][order]
    wk = None if weights is None else weights[ok][order]
    starts = np.concatenate([[0], np.cumsum(counts)])
    for bucket in np.flatnonzero(counts):
        br, bc = divmod(int(bucket), plan.sub_cols)
        for item in range(items[bucket]):
            lo = starts[bucket] + item * tpt.ITEM_POINTS
            hi = min(lo + tpt.ITEM_POINTS, starts[bucket + 1])
            assert np.all(bk[lo:hi] == bucket)
            sub = np.bincount(
                lk[lo:hi], minlength=side * side,
                weights=None if wk is None else wk[lo:hi]).astype(out.dtype)
            nz = np.flatnonzero(sub)
            np.add.at(out, (br * side + nz // side, bc * side + nz % side),
                      sub[nz])
    return out


@pytest.mark.parametrize("case", kc.WINDOW_CASES)
def test_window_cases_match_jax_scatter(case):
    fields, row, col, valid = kc.window_case(case)
    jw, tw = _windows(fields)
    want = np.asarray(jh.bin_rowcol_window(
        jnp.asarray(row), jnp.asarray(col), jw, valid=jnp.asarray(valid),
        backend="xla"))
    got = _port_counts(row, col, tw, valid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "all_outside":
        assert not got.any()
    else:
        assert got.sum() > 0


@pytest.mark.parametrize("case", ["ragged", "ragged_thin", "sub_block_edges",
                                  "all_outside"])
def test_window_cases_match_jax_interpret(case):
    """The JAX partitioned kernel in interpret mode, small blocks."""
    fields, row, col, valid = kc.window_case(case)
    jw, tw = _windows(fields)
    want = np.asarray(jpt.bin_rowcol_window_partitioned(
        jnp.asarray(row), jnp.asarray(col), jw, valid=jnp.asarray(valid),
        interpret=True, block_cells=4096, chunk=256))
    np.testing.assert_array_equal(_port_counts(row, col, tw, valid), want)


@pytest.mark.parametrize("case", kc.WINDOW_CASES)
def test_bucketed_model_matches_jax(case):
    """The planned passes, modelled in numpy, bin each case as the JAX
    package does: the plan covers every point, every bucket and every
    work item."""
    fields, row, col, valid = kc.window_case(case)
    jw, tw = _windows(fields)
    plan = tpt.plan_counts(tw, row.shape[0])
    want = np.asarray(jh.bin_rowcol_window(
        jnp.asarray(row), jnp.asarray(col), jw, valid=jnp.asarray(valid),
        backend="xla"))
    np.testing.assert_array_equal(_model_bucketed(row, col, tw, valid, plan),
                                  want)


def test_hot_sub_block_splits_into_items():
    fields, row, col, valid = kc.window_case("hot_sub_block")
    _, tw = _windows(fields)
    r = row - tw.row0
    c = col - tw.col0
    side = tpt.SUB_SIDE
    in_hot = (valid & (r // side == 2) & (c // side == 1))
    assert -(-int(in_hot.sum()) // tpt.ITEM_POINTS) == 3


@pytest.mark.parametrize("shape,n,want", [
    # The headline window and the tiles defaults' window.
    ((4096, 4096), 1 << 25, dict(sub_rows=32, sub_cols=32, groups=1,
                                 chunks=1024, per_chunk=32768,
                                 items_max=2048 + 1024)),
    ((1792, 1280), 996_273, dict(sub_rows=14, sub_cols=10, groups=1,
                                 chunks=264, per_chunk=3776,
                                 items_max=61 + 140)),
    # Ragged sides, and one point.
    ((300, 200), 1, dict(sub_rows=3, sub_cols=2, groups=1, chunks=1,
                         per_chunk=4, items_max=1 + 6)),
    # The largest window below the int32 cell-id refusal: 11 groups of
    # buckets, and chunks capped by the chunk_base budget.
    ((32768, 65535), 1 << 22, dict(sub_rows=256, sub_cols=512, groups=11,
                                   chunks=128, per_chunk=32768,
                                   items_max=256 + 131072)),
])
def test_plan_counts(shape, n, want):
    window = interop.window_from_fields(zoom=16, row0=0, col0=0,
                                        height=shape[0], width=shape[1])
    plan = tpt.plan_counts(window, n)
    assert dataclasses.asdict(plan) == want
    assert plan.group_buckets <= tpt.GROUP_BUCKETS
    assert plan.groups * plan.group_buckets >= plan.buckets
    assert plan.chunks * plan.per_chunk >= n
    assert plan.chunks * plan.buckets <= tpt.MAX_CHUNK_BASE
    assert plan.per_chunk % 4 == 0
    # One allocation: bucket totals, per-chunk offsets, bucket and item
    # starts, then the uint16 cells and the float32 weights, each
    # 16-byte aligned and each with 8 elements of slack past n.
    words = (plan.buckets + plan.chunks * plan.buckets
             + 2 * (plan.buckets + 1))
    assert plan.cells_offset % 4 == 0
    assert words <= plan.cells_offset < words + 4
    wo = plan.weights_offset(n)
    assert wo % 4 == 0
    assert 2 * (wo - plan.cells_offset) >= n + 8
    assert wo - plan.cells_offset < -(-(n + 8) // 2) + 4
    assert plan.scratch_words(n) == wo
    assert plan.scratch_words(n, weighted=True) == wo + n + 8


@pytest.mark.parametrize("n", [0, 1 << 31])
def test_plan_counts_refuses_point_counts(n):
    window = interop.window_from_fields(zoom=12, row0=0, col0=0, height=300,
                                        width=300)
    with pytest.raises(ValueError, match="points"):
        tpt.plan_counts(window, n)


# --- partitioned weights --------------------------------------------------

def _port_weighted(row, col, window, valid, w):
    return tpt.bin_rowcol_window_partitioned(
        torch.as_tensor(row), torch.as_tensor(col), window,
        weights=torch.as_tensor(w), valid=torch.as_tensor(valid)).numpy()


def _assert_weighted(got, want, kind):
    """Integer weights (NaN on dropped lanes included) bit-equal, and
    no NaN in the raster; fractional ones within FRACTIONAL_RTOL."""
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if kind == "fractional":
        np.testing.assert_allclose(got, want, rtol=FRACTIONAL_RTOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", kc.WEIGHT_KINDS)
@pytest.mark.parametrize("case", kc.WINDOW_CASES)
def test_window_weights_match_jax_scatter(case, kind):
    fields, row, col, valid = kc.window_case(case)
    w = kc.window_weights(kind, fields, row, col, valid)
    jw, tw = _windows(fields)
    want = np.asarray(jh.bin_rowcol_window(
        jnp.asarray(row), jnp.asarray(col), jw, weights=jnp.asarray(w),
        valid=jnp.asarray(valid), backend="xla"))
    got = _port_weighted(row, col, tw, valid, w)
    _assert_weighted(got, want, kind)
    assert (got.sum() > 0) == (case != "all_outside")


@pytest.mark.parametrize("kind", ["integer", "fractional"])
@pytest.mark.parametrize("case", ["ragged", "ragged_thin", "sub_block_edges",
                                  "all_outside"])
def test_window_weights_match_jax_interpret(case, kind):
    """The JAX weighted partitioned kernel in interpret mode, small
    blocks."""
    fields, row, col, valid = kc.window_case(case)
    w = kc.window_weights(kind, fields, row, col, valid)
    jw, tw = _windows(fields)
    want = np.asarray(jpt.bin_rowcol_window_partitioned(
        jnp.asarray(row), jnp.asarray(col), jw, weights=jnp.asarray(w),
        valid=jnp.asarray(valid), interpret=True, block_cells=4096,
        chunk=256))
    _assert_weighted(_port_weighted(row, col, tw, valid, w), want, kind)


@pytest.mark.parametrize("kind", kc.WEIGHT_KINDS)
@pytest.mark.parametrize("case", kc.WINDOW_CASES)
def test_bucketed_weighted_model_matches_jax(case, kind):
    """The planned passes carrying each kept point's weight beside its
    cell (a NaN on a dropped lane is never carried) bin each case as the
    JAX package does."""
    fields, row, col, valid = kc.window_case(case)
    w = kc.window_weights(kind, fields, row, col, valid)
    jw, tw = _windows(fields)
    plan = tpt.plan_counts(tw, row.shape[0])
    want = np.asarray(jh.bin_rowcol_window(
        jnp.asarray(row), jnp.asarray(col), jw, weights=jnp.asarray(w),
        valid=jnp.asarray(valid), backend="xla"))
    _assert_weighted(_model_bucketed(row, col, tw, valid, plan, w), want,
                     kind)


def test_window_weights_kinds():
    """The weights helper gives what each kind says, from its seed."""
    fields, row, col, valid = kc.window_case("ragged")
    ints = kc.window_weights("integer", fields, row, col, valid)
    assert ints.dtype == np.float32
    assert ints.min() >= 0 and ints.max() <= kc.WEIGHT_BOUND
    assert np.all(ints == np.round(ints))
    frac = kc.window_weights("fractional", fields, row, col, valid)
    assert np.any(frac != np.round(frac))
    nan = kc.window_weights("nan_on_dropped", fields, row, col, valid)
    r, c = row - fields["row0"], col - fields["col0"]
    ok = ((r >= 0) & (r < fields["height"]) & (c >= 0)
          & (c < fields["width"]) & valid)
    assert np.all(np.isnan(nan) == ~ok) and 0 < ok.sum() < ok.size
    np.testing.assert_array_equal(nan[ok], ints[ok])
    np.testing.assert_array_equal(
        kc.window_weights("integer", fields, row, col, valid), ints)


# --- window histogram -----------------------------------------------------

@pytest.mark.parametrize("kind", [None, *kc.WEIGHT_KINDS])
@pytest.mark.parametrize("case", kc.HISTOGRAM_CASES)
def test_histogram_cases_match_jax_interpret(case, kind):
    """Counts and each kind of weights through the port's plain version
    and through the JAX Pallas kernel in interpret mode."""
    fields, row, col, valid = kc.histogram_case(case)
    jw, tw = _windows(fields)
    w = None if kind is None else kc.window_weights(kind, fields, row, col,
                                                     valid)
    want = np.asarray(jpk.bin_rowcol_window_pallas(
        jnp.asarray(row), jnp.asarray(col), jw,
        weights=None if w is None else jnp.asarray(w),
        valid=jnp.asarray(valid), interpret=True))
    got = tpk.bin_rowcol_window_pallas(
        torch.as_tensor(row), torch.as_tensor(col), tw,
        weights=None if w is None else torch.as_tensor(w),
        valid=torch.as_tensor(valid)).numpy()
    if kind is None:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want.astype(np.int32))
    else:
        _assert_weighted(got, want, kind)


def test_histogram_cases_place_points():
    """The generator builds what the case names say."""
    fields, *_ = kc.histogram_case("square_256")
    assert (fields["height"], fields["width"]) == (256, 256)
    fields, *_ = kc.histogram_case("ragged_255x257")
    assert fields["height"] * fields["width"] == 65_535
    fields, *_ = kc.histogram_case("one_row")
    assert fields["height"] == 1
    fields, row, col, valid = kc.histogram_case("slice_edges")
    flat = ((row.astype(np.int64) - fields["row0"]) * fields["width"]
            + col - fields["col0"])
    for meet in (kc.SLICE_CELLS // 2, kc.SLICE_CELLS,
                 3 * kc.SLICE_CELLS // 2):
        assert meet % fields["width"] != 0  # bands meet mid-row
        assert np.any(flat == meet - 1) and np.any(flat == meet)
    fields, row, col, valid = kc.histogram_case("hot_cell")
    hot = (row == fields["row0"] + 17) & (col == fields["col0"] + 40) & valid
    assert hot.sum() > 1 << 16


def _model_banded(row, col, window, valid, plan, weights=None):
    """The histogram kernel's plan in numpy: walkers of ``plan.bands``
    blocks step over the points STEP_POINTS at a time; each block keeps
    the points of its band in its slice, and each slice is flushed into
    the window once. ``bands == 0``: every point straight into the
    window."""
    n = row.shape[0]
    cells = window.height * window.width
    r = row.astype(np.int64) - window.row0
    c = col.astype(np.int64) - window.col0
    ok = ((r >= 0) & (r < window.height) & (c >= 0) & (c < window.width)
          & valid)
    cell = np.where(ok, r * window.width + c, -1)
    w = np.ones(n) if weights is None else weights
    dtype = np.int32 if weights is None else np.float32
    out = np.zeros(cells, dtype)
    if plan.bands == 0:
        np.add.at(out, cell[ok], w[ok].astype(dtype))
        return out.reshape(window.shape)
    walkers = plan.blocks // plan.bands
    walker = (np.arange(n) // tpk.STEP_POINTS) % walkers
    band = np.where(ok, cell >> plan.slice_shift, -1)
    assert np.all(band[ok] < plan.bands)
    seen = np.zeros(n, np.int64)
    for wk in range(walkers):
        for b in range(plan.bands):
            lo = b << plan.slice_shift
            size = max(0, min(1 << plan.slice_shift, cells - lo))
            assert size * 4 <= tpk.SLICE_BYTES
            mine = (walker == wk) & (band == b)
            seen += mine
            part = np.bincount(cell[mine] - lo, minlength=size,
                               weights=w[mine]).astype(dtype)
            out[lo:lo + size] += part
    np.testing.assert_array_equal(seen, ok.astype(np.int64))
    return out.reshape(window.shape)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", kc.HISTOGRAM_CASES)
def test_banded_model_matches_jax(case, weighted):
    """The planned bands and grid (on a card of 132 SMs, and of 3 so
    several walkers share the points), modelled in numpy, bin each case
    as the JAX package does."""
    fields, row, col, valid = kc.histogram_case(case)
    jw, tw = _windows(fields)
    w = (kc.window_weights("integer", fields, row, col, valid)
         if weighted else None)
    want = np.asarray(jh.bin_rowcol_window(
        jnp.asarray(row), jnp.asarray(col), jw,
        weights=None if w is None else jnp.asarray(w),
        valid=jnp.asarray(valid), backend="xla"))
    for sms in (132, 3):
        plan = tpk.plan_histogram(tw, row.shape[0], sms)
        np.testing.assert_array_equal(
            _model_banded(row, col, tw, valid, plan, w), want)


@pytest.mark.parametrize("shape,n,want", [
    # The tiles one-tile window and the z15 window, 2^25 points.
    ((256, 256), 996_273, dict(bands=2, slice_shift=15, blocks=132)),
    ((256, 256), 1 << 25, dict(bands=2, slice_shift=15, blocks=132)),
    # Ragged: 65,535 cells take the same two bands.
    ((255, 257), 1 << 25, dict(bands=2, slice_shift=15, blocks=132)),
    # One band, and few points (fewer walkers than SMs).
    ((32, 32), 1 << 25, dict(bands=1, slice_shift=10, blocks=132)),
    ((1, 300), 5, dict(bands=1, slice_shift=9, blocks=1)),
    ((256, 256), 10_000, dict(bands=2, slice_shift=15, blocks=6)),
    # Four bands, and more than MAX_BANDS: the global-atomic build.
    ((4, 32768), 1 << 25, dict(bands=4, slice_shift=15, blocks=132)),
    ((16, 32768), 1 << 25, dict(bands=0, slice_shift=0, blocks=132)),
])
def test_plan_histogram(shape, n, want):
    window = interop.window_from_fields(zoom=16, row0=0, col0=0,
                                        height=shape[0], width=shape[1])
    plan = tpk.plan_histogram(window, n, 132)
    assert dataclasses.asdict(plan) == want
    cells = shape[0] * shape[1]
    if plan.bands:
        assert plan.bands <= tpk.MAX_BANDS
        assert plan.blocks % plan.bands == 0
        assert plan.bands << plan.slice_shift >= cells
        assert (plan.bands - 1) * (tpk.SLICE_BYTES // 4) < cells
        assert min(1 << plan.slice_shift, cells) * 4 <= tpk.SLICE_BYTES
        assert plan.blocks <= 132 * tpk.BLOCKS_PER_SM
    else:
        assert -(-cells // (tpk.SLICE_BYTES // 4)) > tpk.MAX_BANDS


@pytest.mark.parametrize("n,sms", [(0, 132), (5, 0)])
def test_plan_histogram_refusals(n, sms):
    window = interop.window_from_fields(zoom=12, row0=0, col0=0, height=64,
                                        width=64)
    with pytest.raises(ValueError, match="no histogram plan"):
        tpk.plan_histogram(window, n, sms)


# --- projection -----------------------------------------------------------

def _oracle_projection(lat, lon, zoom):
    """The reference's scalar rows and columns (NaN where CPython's math
    refuses the point) and the validity they give."""
    def scalar(f, x):
        try:
            return float(f(x, zoom))
        except (ValueError, OverflowError):
            return math.nan

    rows = np.array([scalar(oracle.row_from_latitude, x) for x in lat])
    cols = np.array([scalar(oracle.column_from_longitude, x) for x in lon])
    n = 1 << zoom
    with np.errstate(invalid="ignore"):
        valid = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < n)
    return rows, cols, valid


@pytest.mark.parametrize("case", kc.PROJECTION_CASES)
def test_projection_cases_match_jax_and_reference(case):
    lat, lon, zoom = kc.projection_case(case)
    row, col, valid = (x.numpy() for x in tmerc.project_points(
        torch.as_tensor(lat), torch.as_tensor(lon), zoom))
    assert row.dtype == np.int32 and col.dtype == np.int32
    assert row.shape == col.shape == valid.shape == lat.shape
    jr, jc, jv = jmerc.project_points(jnp.asarray(lat), jnp.asarray(lon),
                                      zoom, dtype=jnp.float64)
    np.testing.assert_array_equal(valid, np.asarray(jv))
    np.testing.assert_array_equal(row, np.asarray(jr))
    np.testing.assert_array_equal(col, np.asarray(jc))
    wr, wc, wv = _oracle_projection(lat, lon, zoom)
    np.testing.assert_array_equal(valid, wv)
    np.testing.assert_array_equal(row[wv], wr[wv])
    np.testing.assert_array_equal(col[wv], wc[wv])
    assert not row[~wv].any() and not col[~wv].any()
