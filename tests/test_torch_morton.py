"""The port's Morton codes at both widths against heatmap_tpu.tilemath.
morton on the CPU: int32 codes at zooms 0-15 and int64 codes at zooms
0-29 encode, decode and take parents exactly as the JAX functions do, the
zoom refusals read the same, and the range-ownership helpers the
write plane routes with agree with the JAX ones and with brute force.
The batch job's detail codes (int64) are unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.tilemath import morton as jmorton
from heatmap_tpu_torch.tilemath import morton as tmorton


def _rowcol(zoom, seed, n=3000):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 1 << zoom, n)
    col = rng.integers(0, 1 << zoom, n)
    # The extremes of the grid ride along.
    edge = (1 << zoom) - 1
    return (np.concatenate([row, [0, edge, 0, edge]]),
            np.concatenate([col, [0, edge, edge, 0]]))


@pytest.mark.parametrize("tdtype,jdtype,zooms", [
    (torch.int32, jnp.int32, range(0, 16)),
    (torch.int64, jnp.int64, range(0, 30)),
])
def test_encode_decode_parent_match_jax(tdtype, jdtype, zooms):
    for zoom in zooms:
        row, col = _rowcol(zoom, zoom)
        want = np.asarray(jmorton.morton_encode(
            jnp.asarray(row, jdtype), jnp.asarray(col, jdtype), dtype=jdtype,
            zoom=zoom))
        got = tmorton.morton_encode(torch.as_tensor(row),
                                    torch.as_tensor(col), dtype=tdtype,
                                    zoom=zoom)
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(zoom))
        jr, jc = jmorton.morton_decode(jnp.asarray(want))
        tr, tc = tmorton.morton_decode(got)
        assert tr.dtype == tc.dtype == tdtype
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tr.numpy(), row)
        np.testing.assert_array_equal(tc.numpy(), col)
        for levels in range(0, zoom + 1, max(1, zoom // 4)):
            np.testing.assert_array_equal(
                tmorton.morton_parent(got, levels).numpy(),
                np.asarray(jmorton.morton_parent(jnp.asarray(want),
                                                 levels)))


def test_default_width_is_int32_as_jax():
    row, col = _rowcol(12, 3)
    got = tmorton.morton_encode(torch.as_tensor(row), torch.as_tensor(col))
    want = jmorton.morton_encode(jnp.asarray(row, jnp.int32),
                                 jnp.asarray(col, jnp.int32))
    assert got.dtype == torch.int32 and want.dtype == jnp.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int32_beyond_zoom15_truncates_as_jax():
    """Without ``zoom`` a too-wide coordinate is bit-truncated the same
    way in both packages (the reason to pass ``zoom``)."""
    row, col = _rowcol(17, 4, n=500)
    got = tmorton.morton_encode(torch.as_tensor(row), torch.as_tensor(col))
    want = jmorton.morton_encode(jnp.asarray(row, jnp.int32),
                                 jnp.asarray(col, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tdtype,jdtype,zoom", [
    (torch.int32, jnp.int32, 16), (torch.int64, jnp.int64, 30)])
def test_zoom_refusals_match_jax(tdtype, jdtype, zoom):
    z = np.zeros(1, np.int64)
    with pytest.raises(ValueError) as je:
        jmorton.morton_encode(jnp.asarray(z, jdtype), jnp.asarray(z, jdtype),
                              dtype=jdtype, zoom=zoom)
    with pytest.raises(ValueError) as te:
        tmorton.morton_encode(torch.as_tensor(z), torch.as_tensor(z),
                              dtype=tdtype, zoom=zoom)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("seed", range(4))
def test_range_shards_match_jax(seed):
    rng = np.random.default_rng(seed)
    space = 1 << 24
    splits = np.sort(rng.integers(0, space, rng.integers(0, 9)))
    if seed == 3:
        splits = np.asarray([100, 100, 100, 5000])  # duplicate splits
    codes = np.concatenate([rng.integers(0, space, 4000), splits,
                            splits - 1, splits + 1])
    got = tmorton.morton_range_shards_np(splits, codes)
    want = jmorton.morton_range_shards_np(splits, codes)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # A code's shard is the number of splits at or below it.
    np.testing.assert_array_equal(
        got, (splits[None, :] <= codes[:, None]).sum(axis=1))


@pytest.mark.parametrize("trial", range(5))
def test_split_boundary_codes_match_jax_and_brute_force(trial):
    """A tile L levels above detail straddles a split iff its first and
    last detail children land on different shards."""
    rng = np.random.default_rng(19 + trial)
    dz = 12
    splits = np.sort(rng.integers(1, 1 << (2 * dz), 7))
    if trial == 4:
        splits[2] = splits[1] = (splits[1] >> 4) << 4  # aligned, repeated
    assert tmorton.split_boundary_codes_np(splits, 0).size == 0
    for lvl in range(0, 7):
        got = tmorton.split_boundary_codes_np(splits, lvl)
        np.testing.assert_array_equal(
            got, jmorton.split_boundary_codes_np(splits, lvl))
        if lvl == 0:
            continue
        cand = np.unique(splits >> np.int64(2 * lvl))
        lo = cand << np.int64(2 * lvl)
        hi = lo + (np.int64(1) << np.int64(2 * lvl)) - 1
        first = tmorton.morton_range_shards_np(splits, lo)
        last = tmorton.morton_range_shards_np(splits, hi)
        assert set(got.tolist()) == set(cand[first != last].tolist())
    assert tmorton.split_boundary_codes_np([], 3).size == 0


def test_tilemath_exports_as_jax():
    import heatmap_tpu.tilemath as jtm
    import heatmap_tpu_torch.tilemath as ttm

    for name in ("morton_decode", "morton_encode", "morton_parent",
                 "morton_range_shards_np", "split_boundary_codes_np"):
        assert hasattr(jtm, name) and getattr(ttm, name) is getattr(
            tmorton, name)


@pytest.mark.parametrize("zoom", [12, 21])
def test_batch_job_codes_unchanged(zoom):
    """``pipeline.batch.project_codes`` still gives int64 detail codes
    equal to the JAX jit's and to the host encoder's."""
    from heatmap_tpu.pipeline import batch as jbatch
    from heatmap_tpu_torch.pipeline import batch as tbatch
    from heatmap_tpu_torch.tilemath import mercator

    rng = np.random.default_rng(zoom)
    lat = np.concatenate([47.6 + rng.normal(0, 0.5, 2000), [90.0, np.nan]])
    lon = np.concatenate([-122.3 + rng.normal(0, 0.7, 2000), [0.0, 1.0]])
    codes, valid = tbatch.project_codes(lat, lon, zoom, "cpu")
    assert codes.dtype == torch.int64
    jcodes, jvalid = jbatch._project_codes_jit(jnp.asarray(lat),
                                               jnp.asarray(lon), zoom)
    v = valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(jvalid))
    np.testing.assert_array_equal(codes.numpy()[v], np.asarray(jcodes)[v])
    row, col, _ = mercator.project_points_np(lat, lon, zoom)
    np.testing.assert_array_equal(codes.numpy()[v],
                                  tmorton.morton_encode_np(row, col)[v])
