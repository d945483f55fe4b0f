"""The edge cases of the segment-reduce and partitioned-counts kernels
(``heatmap_tpu_torch.kernel_cases``, the inputs ``chip_smoke.py`` runs on
the card) through the port's plain versions on the CPU and through the
JAX package: bit-equal. Also the host-side planning of both kernels:
tile counts and status words, the sub-block grid of windows with ragged
edges, chunking, work items and scratch sizes, checked by a numpy model
of the bucketed passes that must bin every case as the JAX package
does.

The CUDA kernels run only on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.ops import histogram as jh
from heatmap_tpu.ops import partitioned as jpt
from heatmap_tpu.ops import sparse_partitioned as jsp
from heatmap_tpu.ops.sparse import aggregate_sorted_keys as j_agg
from heatmap_tpu_torch import interop
from heatmap_tpu_torch import kernel_cases as kc
from heatmap_tpu_torch.ops import partitioned as tpt
from heatmap_tpu_torch.ops import sparse_partitioned as tsp

SENTINEL = kc.SENTINEL
TILE = tsp.TILE_KEYS
BOUND = 100
#: The JAX kernel's exactness slab, small so interpret mode stays quick
#: (as in tests/test_torch_segment.py).
SLAB = 8192


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


def _model_counts(row, col, window, valid, plan):
    """The bucketed passes in numpy, on ``plan``'s geometry: buckets by
    sub-block, chunks and groups of passes 1 and 3, work items of pass
    4, and each item's local cells flushed back into the window."""
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
    out = np.zeros((window.height, window.width), np.int32)
    order = np.argsort(b[ok], kind="stable")
    bk, lk = b[ok][order], local[ok][order]
    starts = np.concatenate([[0], np.cumsum(counts)])
    for bucket in np.flatnonzero(counts):
        br, bc = divmod(int(bucket), plan.sub_cols)
        for item in range(items[bucket]):
            lo = starts[bucket] + item * tpt.ITEM_POINTS
            hi = min(lo + tpt.ITEM_POINTS, starts[bucket + 1])
            assert np.all(bk[lo:hi] == bucket)
            sub = np.bincount(lk[lo:hi], minlength=side * side)
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
    np.testing.assert_array_equal(_model_counts(row, col, tw, valid, plan),
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
    words = plan.chunks * plan.buckets + 2 * (plan.buckets + 1)
    assert plan.cells_offset % 4 == 0
    assert words <= plan.cells_offset < words + 4
    assert 2 * (plan.scratch_words(n) - plan.cells_offset) >= n + 8


@pytest.mark.parametrize("n", [0, 1 << 31])
def test_plan_counts_refuses_point_counts(n):
    window = interop.window_from_fields(zoom=12, row0=0, col0=0, height=300,
                                        width=300)
    with pytest.raises(ValueError, match="points"):
        tpt.plan_counts(window, n)
