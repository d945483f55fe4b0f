"""The port's segment reduce (plain PyTorch versions, on the CPU) against
heatmap_tpu's ``aggregate_sorted_keys`` and its Pallas
``aggregate_sorted_keys_partitioned`` in interpret mode: bit-equal on
counts and bounded-integer weights, including overflow, sentinel
padding, shifts, the invalid-weight poison and the refusals.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
bit-equal to these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.ops import sparse_partitioned as jsp
from heatmap_tpu.ops.sparse import aggregate_sorted_keys as j_agg
from heatmap_tpu_torch.ops import sparse_partitioned as tsp
from heatmap_tpu_torch.ops.pyramid import (
    pyramid_sparse_morton,
    pyramid_sparse_morton_partitioned,
)
from heatmap_tpu_torch.ops.sparse import aggregate_keys
from heatmap_tpu_torch.ops.sparse import aggregate_sorted_keys as t_agg

SENTINEL = np.iinfo(np.int64).max
#: A small exactness slab keeps the interpret-mode kernel to one 8192
#: lane pass (the default 2^24 slab would pad every call to 16M lanes).
SLAB = 8192
CASES = ["clustered", "unique", "sentinel_padding", "58_bit", "tiny", "empty"]


def _keys(case):
    rng = np.random.default_rng(CASES.index(case))
    if case == "clustered":
        return np.sort(np.repeat(rng.choice(1 << 40, 40, replace=False),
                                 rng.integers(10, 90, 40)))
    if case == "unique":
        return np.sort(rng.choice(1 << 50, 3000, replace=False))
    if case == "sentinel_padding":
        return np.sort(np.concatenate([rng.integers(0, 1 << 30, 2000),
                                       np.full(700, SENTINEL)]))
    if case == "58_bit":
        return np.sort(rng.integers(1 << 57, 1 << 58, 2000, dtype=np.int64))
    if case == "tiny":
        return np.asarray([7, 7, 8], np.int64)
    if case == "empty":
        return np.empty(0, np.int64)
    raise ValueError(case)


def _assert_same(got, want, capacity):
    gu, gs, gn = (np.asarray(x) for x in got)
    wu, ws, wn = (np.asarray(x) for x in want)
    assert int(gn) == int(wn)
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(gs.astype(ws.dtype), ws)
    assert gu.shape == (capacity,) and gs.shape == (capacity,)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("capacity_frac", [1.0, 0.5])
def test_counts_match_jax_scatter(case, capacity_frac):
    """Counts: port plain versions == JAX scatter reduce, including
    capacity below the unique count (overflow: n_unique > capacity)."""
    keys = _keys(case)
    capacity = max(1, int(len(np.unique(keys)) * capacity_frac))
    want = j_agg(jnp.asarray(keys, jnp.int64),
                 jnp.ones(len(keys), jnp.int32), capacity, sentinel=SENTINEL)
    tk = torch.as_tensor(keys)
    got_scatter = t_agg(tk, torch.ones(len(keys), dtype=torch.int32),
                        capacity)
    got_part = tsp.aggregate_sorted_keys_partitioned(tk, capacity)
    assert got_part[1].dtype == torch.int32
    _assert_same(got_scatter, want, capacity)
    _assert_same(got_part, want, capacity)


@pytest.mark.parametrize("case", ["clustered", "sentinel_padding", "tiny",
                                  "empty"])
def test_counts_match_jax_partitioned_interpret(case):
    """The JAX Pallas kernel in interpret mode: same (unique, sums,
    n_unique), bit for bit."""
    keys = _keys(case)
    capacity = 4096
    want = jsp.aggregate_sorted_keys_partitioned(
        jnp.asarray(keys, jnp.int64), capacity, interpret=True, slab=SLAB)
    got = tsp.aggregate_sorted_keys_partitioned(torch.as_tensor(keys),
                                                capacity)
    _assert_same(got, want, capacity)


@pytest.mark.parametrize("shift", [0, 10, 30])
def test_shift_reads_shifted_keys(shift):
    """``shift`` reduces ``keys >> shift`` against the shifted sentinel
    without materialising the shifted array in the caller."""
    keys = _keys("sentinel_padding")
    sent = SENTINEL >> shift
    shifted = np.asarray(keys) >> shift
    capacity = 3000
    want = j_agg(jnp.asarray(shifted), jnp.ones(len(keys), jnp.int32),
                 capacity, sentinel=sent)
    got = tsp.aggregate_sorted_keys_partitioned(
        torch.as_tensor(keys), capacity, sentinel=sent, shift=shift)
    _assert_same(got, want, capacity)


def _weighted(seed, n=3000, bound=100):
    rng = np.random.default_rng(seed)
    keys = np.repeat(rng.choice(1 << 40, 60, replace=False),
                     rng.integers(10, 90, 60))[:n]
    keys = np.concatenate([keys, np.full(100, SENTINEL)])
    w = rng.integers(0, bound + 1, keys.size).astype(np.float64)
    order = np.argsort(keys, kind="stable")
    return keys[order], w[order]


@pytest.mark.parametrize("capacity", [64, 30])
def test_weighted_integer_bit_exact(capacity):
    keys, w = _weighted(11)
    want_scatter = j_agg(jnp.asarray(keys), jnp.asarray(w), capacity,
                         sentinel=SENTINEL)
    want_kernel = jsp.aggregate_sorted_keys_partitioned(
        jnp.asarray(keys), capacity, interpret=True, slab=SLAB,
        sorted_weights=jnp.asarray(w), weight_bound=100)
    got = tsp.aggregate_sorted_keys_partitioned(
        torch.as_tensor(keys), capacity, sorted_weights=torch.as_tensor(w),
        weight_bound=100)
    assert got[1].dtype == torch.float64
    _assert_same(got, want_scatter, capacity)
    _assert_same(got, want_kernel, capacity)


def test_weighted_zero_sum_segment_keeps_its_key():
    keys = np.asarray([5, 5, 9, 9, 9, 12], np.int64)
    w = np.asarray([0, 0, 3, 4, 0, 7], np.float64)
    u, s, n = tsp.aggregate_sorted_keys_partitioned(
        torch.as_tensor(keys), 8, sorted_weights=torch.as_tensor(w),
        weight_bound=8)
    assert int(n) == 3
    assert u[:3].tolist() == [5, 9, 12] and s[:3].tolist() == [0.0, 7.0, 7.0]


@pytest.mark.parametrize("bad_w", [2.5, -1.0, 2000.0, float("nan")])
def test_invalid_weight_poisons_n_unique(bad_w):
    """A fractional, negative, over-bound or NaN weight sets n_unique
    past capacity, as the JAX kernel does; a bad weight on a sentinel
    lane is ignored."""
    keys = np.sort(np.random.default_rng(12).integers(0, 1000, 5000))
    w = np.ones(5000)
    w[1234] = bad_w
    _, _, got_n = tsp.aggregate_sorted_keys_partitioned(
        torch.as_tensor(keys), 2048, sorted_weights=torch.as_tensor(w),
        weight_bound=1000)
    assert int(got_n) > 2048
    if np.isfinite(bad_w):
        _, _, want_n = jsp.aggregate_sorted_keys_partitioned(
            jnp.asarray(keys), 2048, interpret=True, slab=SLAB,
            sorted_weights=jnp.asarray(w), weight_bound=1000)
        assert int(want_n) > 2048
    keys_pad = np.concatenate([np.arange(10), [SENTINEL]])
    w_pad = np.concatenate([np.ones(10), [bad_w]])
    _, _, n = tsp.aggregate_sorted_keys_partitioned(
        torch.as_tensor(keys_pad), 16, sorted_weights=torch.as_tensor(w_pad),
        weight_bound=1000)
    assert int(n) == 10


def test_refusals_match_jax_wording():
    tk = torch.zeros(2048, dtype=torch.int64)
    with pytest.raises(ValueError, match="weight_bound") as t_err:
        tsp.aggregate_sorted_keys_partitioned(
            tk, 8, sorted_weights=torch.ones(2048, dtype=torch.float64))
    with pytest.raises(ValueError, match="weight_bound") as j_err:
        jsp.aggregate_sorted_keys_partitioned(
            jnp.zeros(8, jnp.int64), 8, interpret=True,
            sorted_weights=jnp.ones(8))
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="too large for the exactness") as t_err:
        tsp.aggregate_sorted_keys_partitioned(
            tk, 64, sorted_weights=torch.ones(2048, dtype=torch.float64),
            weight_bound=20_000)
    with pytest.raises(ValueError, match="too large for the exactness") as j_err:
        jsp.aggregate_sorted_keys_partitioned(
            jnp.zeros(2048, jnp.int64), 64, interpret=True,
            sorted_weights=jnp.ones(2048), weight_bound=20_000)
    assert str(t_err.value) == str(j_err.value)


def test_wrapper_checks_inputs():
    with pytest.raises(TypeError, match="int64"):
        tsp.aggregate_sorted_keys_partitioned(
            torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="contiguous"):
        tsp.aggregate_sorted_keys_partitioned(
            torch.zeros(8, dtype=torch.int64)[::2], 4)
    with pytest.raises(ValueError, match="capacity"):
        tsp.aggregate_sorted_keys_partitioned(
            torch.zeros(4, dtype=torch.int64), 1 << 31)
    with pytest.raises(TypeError, match="float64"):
        tsp.aggregate_sorted_keys_partitioned(
            torch.zeros(4, dtype=torch.int64), 4,
            sorted_weights=torch.ones(4), weight_bound=4)


def test_cpu_tensors_take_the_plain_version():
    """The launch counter moves only when the CUDA kernel launches."""
    before = tsp.aggregate_sorted_keys_partitioned.launches
    tsp.aggregate_sorted_keys_partitioned(torch.arange(10), 16)
    assert tsp.aggregate_sorted_keys_partitioned.launches == before


@pytest.mark.parametrize("weighted", [False, True])
def test_pyramids_match_jax(weighted):
    """Both port pyramids == the JAX scatter pyramid at every level,
    with invalid lanes, per-level capacities and the int64-max padding."""
    from heatmap_tpu.ops.pyramid import pyramid_sparse_morton as j_pyr

    rng = np.random.default_rng(7)
    n = 4000
    codes = np.sort(rng.choice(1 << 26, 300, replace=False))[
        rng.integers(0, 300, n)].astype(np.int64)
    valid = rng.random(n) < 0.9
    w = rng.integers(0, 50, n).astype(np.float64) if weighted else None
    levels, caps = 5, [n, 1024, 512, 512, 300, 300]
    want = j_pyr(jnp.asarray(codes), valid=jnp.asarray(valid),
                 weights=None if w is None else jnp.asarray(w),
                 levels=levels, capacity=caps,
                 acc_dtype=jnp.float64 if weighted else None)
    tw = None if w is None else torch.as_tensor(w)
    got_scatter = pyramid_sparse_morton(
        torch.as_tensor(codes), valid=torch.as_tensor(valid), weights=tw,
        levels=levels, capacity=caps,
        acc_dtype=torch.float64 if weighted else None)
    got_part = pyramid_sparse_morton_partitioned(
        torch.as_tensor(codes), valid=torch.as_tensor(valid), weights=tw,
        weight_bound=50 if weighted else None, levels=levels, capacity=caps)
    for lvl in range(levels + 1):
        _assert_same(got_scatter[lvl], want[lvl], caps[lvl])
        _assert_same(got_part[lvl], want[lvl], caps[lvl])


def test_aggregate_keys_weighted_stable_order():
    """Fractional weights: the stable sort keeps host summation order,
    so the scatter reduce matches the JAX scatter reduce bit for bit."""
    from heatmap_tpu.ops.sparse import aggregate_keys as j_keys

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 50, 3000).astype(np.int64)
    w = rng.random(3000)
    want = j_keys(jnp.asarray(keys), weights=jnp.asarray(w), capacity=64,
                  acc_dtype=jnp.float64)
    got = aggregate_keys(torch.as_tensor(keys), weights=torch.as_tensor(w),
                         capacity=64, acc_dtype=torch.float64)
    _assert_same(got, want, 64)
