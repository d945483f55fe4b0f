"""The port's torch twins of the JAX package's jit'd helpers
(``haar2d_torch``, ``grid_from_rows_torch``, ``integral2d_torch``) and
its numpy ``merge_shard_sats``, on the CPU against the JAX functions:
bit-equal (``rtol=0``) on integer grids, with pad lanes masked by
``valid=``, and exported where the JAX package exports them."""

import numpy as np
import pytest
import torch

from heatmap_tpu import analytics as janalytics
from heatmap_tpu import synopsis as jsynopsis
from heatmap_tpu.analytics import integral as jintegral
from heatmap_tpu.synopsis import transform as jtransform
from heatmap_tpu_torch import analytics, synopsis
from heatmap_tpu_torch.analytics import integral
from heatmap_tpu_torch.synopsis import transform


def _rows(seed, n, side, pad=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, side, n + pad)
    cols = rng.integers(0, side, n + pad)
    values = rng.integers(0, 50, n + pad).astype(np.float64)
    valid = np.arange(n + pad) < n
    return rows, cols, values, valid


@pytest.mark.parametrize("side", [1, 2, 8, 64])
@pytest.mark.parametrize("pad", [0, 17])
def test_grid_from_rows_torch_equal_jax(side, pad):
    rows, cols, values, valid = _rows(side + pad, 300, side, pad)
    got = transform.grid_from_rows_torch(
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(values), side,
        valid=torch.from_numpy(valid) if pad else None, device="cpu")
    want = np.asarray(jtransform.grid_from_rows_jax(
        rows, cols, values, side, valid=valid if pad else None))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    np.testing.assert_array_equal(
        transform.grid_from_rows_torch(rows[:300], cols[:300],
                                       values[:300], side).numpy(),
        transform.grid_from_rows_np(rows[:300], cols[:300], values[:300],
                                    side))


def test_grid_from_rows_torch_edge_indices_follow_jax():
    """A negative index counts from the end and one past the grid is
    dropped, as the JAX scatter does."""
    rows = np.array([0, -1, 3, 4, -5, 2])
    cols = np.array([0, 2, -2, 1, 0, 7])
    values = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    got = transform.grid_from_rows_torch(rows, cols, values, 4)
    want = np.asarray(jtransform.grid_from_rows_jax(rows, cols, values, 4))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("side", [1, 2, 4, 32, 128])
def test_haar2d_torch_equal_jax(side):
    rng = np.random.default_rng(side)
    grid = rng.integers(0, 1000, (side, side)).astype(np.float64)
    got = transform.haar2d_torch(torch.from_numpy(grid), device="cpu")
    want = np.asarray(jtransform.haar2d_jax(grid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    np.testing.assert_array_equal(got.numpy(), transform.haar2d_np(grid))
    np.testing.assert_array_equal(transform.inv_haar2d_np(got.numpy()),
                                  grid)


def test_haar2d_torch_refuses_as_jax():
    for bad in (np.zeros((3, 3)), np.zeros((4, 2))):
        with pytest.raises(ValueError) as a:
            transform.haar2d_torch(torch.from_numpy(bad))
        with pytest.raises(ValueError) as b:
            jtransform.haar2d_jax(bad)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("shape", [(1, 1), (8, 8), (64, 64), (5, 9)])
def test_integral2d_torch_equal_jax(shape):
    rng = np.random.default_rng(shape[0])
    grid = rng.integers(0, 100, shape).astype(np.float64)
    got = integral.integral2d_torch(torch.from_numpy(grid), device="cpu")
    want = np.asarray(jintegral.integral2d_jax(grid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    np.testing.assert_array_equal(got.numpy(), integral.integral2d_np(grid))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_merge_shard_sats_equal_jax(shards):
    rng = np.random.default_rng(shards)
    grids = [rng.integers(0, 20, (16, 16)).astype(np.float64)
             for _ in range(shards)]
    sats = [integral.integral2d_np(g) for g in grids]
    got = integral.merge_shard_sats(sats)
    assert got.tobytes() == jintegral.merge_shard_sats(sats).tobytes()
    np.testing.assert_array_equal(got, integral.integral2d_np(sum(grids)))


def test_merge_shard_sats_refusals_match_jax():
    for parts in ([], [np.zeros((2, 2)), np.zeros((3, 3))]):
        with pytest.raises(ValueError) as a:
            integral.merge_shard_sats(parts)
        with pytest.raises(ValueError) as b:
            jintegral.merge_shard_sats(parts)
        assert str(a.value) == str(b.value)


def test_twins_exported_where_jax_exports_them():
    assert synopsis.haar2d_torch is transform.haar2d_torch
    assert synopsis.grid_from_rows_torch is transform.grid_from_rows_torch
    assert analytics.integral2d_torch is integral.integral2d_torch
    assert analytics.merge_shard_sats is integral.merge_shard_sats
    assert {"haar1d_np", "inv_haar1d_np"} <= set(transform.__all__)
    assert set(jtransform.__all__) == {
        n.replace("_torch", "_jax") for n in transform.__all__}
    assert set(jintegral.__all__) == {
        n.replace("_torch", "_jax") for n in integral.__all__}
    assert hasattr(jsynopsis, "haar2d_jax")
    assert hasattr(janalytics, "merge_shard_sats")
