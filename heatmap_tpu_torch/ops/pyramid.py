"""Zoom pyramids: reshape-sums of dense window rasters, and sparse
pyramids over sorted Morton (or composite) keys.

Port of heatmap_tpu/ops/pyramid.py. A dense window raster rolls up with
2x2 reshape-sums (:func:`coarsen_raster`, :func:`pyramid_from_raster`).
Morton codes sorted once at detail zoom stay sorted under the ``>> 2``
parent shift, so every coarser sparse level is a segment reduce over the
already-sorted order:

- :func:`pyramid_sparse_morton` (the "scatter" backend) re-reduces each
  level from the previous level's capacity-sized aggregates;
- :func:`pyramid_sparse_morton_partitioned` reduces EVERY level from
  the one sorted point stream read under ``key >> 2*level``, on the
  CUDA segment-reduce kernel (ops/sparse_partitioned.py).
"""

from __future__ import annotations

import torch

from heatmap_tpu_torch.devices import stage
from heatmap_tpu_torch.ops import sparse as sparse_ops
from heatmap_tpu_torch.ops import sparse_partitioned as sp

SENTINEL = torch.iinfo(torch.int64).max


def coarsen_raster(raster):
    """Sum 2x2 blocks: (..., H, W) -> (..., H//2, W//2), in the raster's
    own dtype (torch would widen an int32 sum to int64).

    Requires even H, W (Window.aligned_to guarantees this for aligned
    windows).
    """
    *batch, h, w = raster.shape
    if h % 2 or w % 2:
        raise ValueError(f"raster {tuple(raster.shape)} not 2x2-coarsenable")
    r = raster.reshape(*batch, h // 2, 2, w // 2, 2)
    return r.sum(dim=(-3, -1), dtype=raster.dtype)


def pyramid_from_raster(raster, levels: int):
    """Full rollup: returns [raster, coarsen(raster), ...], levels+1 entries.

    The i-th entry is the detail raster coarsened i zooms; with an
    aligned Window the entry at level i covers rows
    [row0>>i, (row0+H)>>i) of the global grid at zoom-i.
    """
    out = [raster]
    for _ in range(levels):
        raster = coarsen_raster(raster)
        out.append(raster)
    return out


def _level_caps(capacity, n: int, levels: int) -> list:
    """Normalize the per-level capacity spec (int / None / list)."""
    caps = (
        [capacity or n] * (levels + 1)
        if capacity is None or isinstance(capacity, int)
        else list(capacity)
    )
    if len(caps) != levels + 1:
        raise ValueError(f"need {levels + 1} capacities, got {len(caps)}")
    return caps


def adaptive_keep(count, size: int) -> int | None:
    """The array length that level data of ``size`` slots, ``count`` of
    them real, shrinks to under ``adaptive=True``: the next power of two
    at or above the real count, at least 64; None when nothing shrinks
    (the level overflowed, ``count > size``, or is already that small).
    Reads ``count`` on the host: one device sync per level. Slots past
    ``count`` are sentinel padding, so dropping them changes no result.
    """
    n_real = int(count)
    if n_real > size:
        return None
    keep = max(64, 1 << max(0, n_real - 1).bit_length())
    return keep if keep < size else None


def pyramid_sparse_morton(codes, weights=None, valid=None, levels: int = 0,
                          capacity=None, acc_dtype=None, timer=None,
                          adaptive: bool = False):
    """Per-level ``(unique codes[capacity_i], sums[capacity_i], n_unique)``.

    Entry 0 is the detail zoom, entry i is coarsened by i zooms.
    ``capacity`` is an int (every level) or a per-level list. Levels
    past the first reduce the previous level's unique codes, so the work
    is O(N log N + N + levels * capacity).

    ``adaptive=True`` shrinks every level's input to the previous
    level's real unique count (:func:`adaptive_keep`), so deep levels
    reduce ~``n_unique_0`` slots instead of ``capacity``; results are
    identical. The input never shrinks below the real count (that would
    falsify the unique count overflow detection relies on); a
    configured ``caps[lvl]`` below it bounds only the output, where
    ``n_unique > capacity`` stays detectable.
    """
    n = codes.shape[0]
    caps = _level_caps(capacity, n, levels)
    uniq, sums, count = sparse_ops.aggregate_keys(
        codes, weights=weights, valid=valid, capacity=caps[0],
        acc_dtype=acc_dtype, timer=timer)
    out = [(uniq, sums, count)]
    for lvl in range(1, levels + 1):
        cap = caps[lvl]
        if adaptive:
            keep = adaptive_keep(count, uniq.shape[0])
            if keep is not None:
                uniq, sums = uniq[:keep], sums[:keep]
            cap = min(cap, uniq.shape[0])
        # Parent codes of the previous level's uniques; sentinel slots
        # stay sentinel (a plain shift would make plausible codes).
        with stage(timer, "segment_reduce"):
            parents = torch.where(uniq == SENTINEL, SENTINEL, uniq >> 2)
            uniq, sums, count = sparse_ops.aggregate_sorted_keys(
                parents, sums, cap, sentinel=SENTINEL)
        out.append((uniq, sums, count))
    return out


def pyramid_sparse_morton_partitioned(codes, valid=None, levels: int = 0,
                                      capacity=None, weights=None,
                                      weight_bound: int | None = None,
                                      timer=None, adaptive: bool = False):
    """Sparse pyramid on the segment-reduce kernel.

    Same contract as :func:`pyramid_sparse_morton` (int64 keys, int64-max
    sentinel padding, per-level capacities), but one sort serves every
    level: level ``l`` reduces the sorted stream read as ``key >> 2l``.
    Counts (``weights=None``, int32 sums) or bounded-integer weights
    (``weights`` with ``weight_bound``; float64 sums; a weight outside
    the contract poisons ``n_unique``). Keys must fit 60 bits, which the
    cascade checks.

    ``adaptive=True`` cuts each level's output capacity to
    :func:`adaptive_keep` of the previous level's real unique count (a
    level has no more uniques than the level below it), one host sync
    per level. The kernel still reads the whole sorted stream; only its
    output arrays, and the work past ``n_unique``, shrink. The JAX
    package refuses this combination; here the blobs are unchanged.
    """
    codes = codes.to(torch.int64)
    n = codes.shape[0]
    caps = _level_caps(capacity, n, levels)
    keys = codes if valid is None else torch.where(valid, codes, SENTINEL)
    with stage(timer, "sort"):
        if weights is None:
            skeys = torch.sort(keys).values
            sw = None
        else:
            # Integer sums are order-free, so the unstable sort is fine.
            skeys, order = torch.sort(keys)
            sw = weights.to(torch.float64)[order]
    out = []
    for lvl in range(levels + 1):
        shifted_sentinel = SENTINEL >> (2 * lvl)
        cap = caps[lvl]
        if adaptive and lvl:
            keep = adaptive_keep(out[-1][2], out[-1][0].shape[0])
            if keep is not None:
                cap = min(cap, keep)
        with stage(timer, "segment_reduce"):
            uniq, sums, n_unique = sp.aggregate_sorted_keys_partitioned(
                skeys, cap, sentinel=shifted_sentinel, shift=2 * lvl,
                sorted_weights=sw, weight_bound=weight_bound)
            # Normalize padding to the int64-max sentinel: the level pads
            # with its SHIFTED sentinel, which a `uniq != intmax` mask
            # downstream would let through as phantom cells.
            uniq = torch.where(uniq == shifted_sentinel, SENTINEL, uniq)
        out.append((uniq, sums, n_unique))
    return out
