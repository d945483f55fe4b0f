"""Zoom pyramids: 2x2 sums of dense window rasters, and sparse pyramids
over sorted Morton (or composite) keys.

Port of heatmap_tpu/ops/pyramid.py. A dense window raster rolls up
with 2x2 sums (:func:`pyramid_from_raster`, :func:`coarsen_raster`): on
a CUDA device every level comes from one read of the raster by the
hand-written kernel ``csrc/dense_pyramid.cu``, elsewhere from its plain
version (:func:`_plain`), one level at a time.
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

import ctypes
import functools
import math

import torch

from heatmap_tpu_torch import _build
from heatmap_tpu_torch.devices import cascade_stage
from heatmap_tpu_torch.ops import sparse as sparse_ops
from heatmap_tpu_torch.ops import sparse_partitioned as sp

SENTINEL = torch.iinfo(torch.int64).max

#: Levels that one launch of csrc/dense_pyramid.cu rolls up (its
#: 128 x 128 tiles); a deeper pyramid launches again on the last level.
KERNEL_LEVELS = 7
#: Each level starts this many cells into the shared output buffer from
#: a multiple of it (128 bytes of int32 or float32).
_LEVEL_ALIGN = 32
#: dtype codes of csrc/dense_pyramid.cu's C interface.
_KERNEL_DTYPES = {torch.int32: 0, torch.float32: 1}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (function, argtypes) of csrc/dense_pyramid.cu: in, dtype, batch,
#: batch_stride, row_stride, height, width, n_levels, levels, stream.
_SIGNATURES = (
    ("hm_dense_pyramid", (_P, _I, _I64, _I64, _I64, _I, _I, _I, _P, _P)),
)


def coarsen_raster(raster):
    """Sum 2x2 blocks: (..., H, W) -> (..., H//2, W//2), in the raster's
    own dtype (torch would widen an int32 sum to int64).

    Requires even H, W (Window.aligned_to guarantees this for aligned
    windows). One level of :func:`pyramid_from_raster`.
    """
    return pyramid_from_raster(raster, 1)[1]


def pyramid_from_raster(raster, levels: int):
    """Full rollup: returns [raster, coarsen(raster), ...], levels+1 entries.

    The i-th entry is the detail raster coarsened i zooms; with an
    aligned Window the entry at level i covers rows
    [row0>>i, (row0+H)>>i) of the global grid at zoom-i. Every cell is
    ``(a00 + a01) + (a10 + a11)`` of the four cells below it, in the
    raster's own dtype (an int32 sum wraps).

    The coarser levels are contiguous views of one buffer. On a CUDA
    device they come from ``csrc/dense_pyramid.cu``: one launch for up
    to :data:`KERNEL_LEVELS` levels, one more for each further
    :data:`KERNEL_LEVELS` (counted in ``pyramid_from_raster.launches``);
    it takes int32 and float32 rasters whose last dimension has stride 1
    and whose leading dimensions fold into one, and raises on any other.
    Elsewhere :func:`_plain` computes the same cells. A side that is odd
    where a level would halve it raises ValueError before any work.
    """
    _layout(tuple(raster.shape), levels)
    if raster.device.type == "cuda":
        return [raster, *_launch(raster, levels)]
    return _plain(raster, levels)


pyramid_from_raster.launches = 0


def _plain(raster, levels: int):
    """The plain version of :func:`pyramid_from_raster`, on any device
    and dtype: one level at a time, each cell summed in the kernel's
    order by torch's elementwise adds."""
    out = [raster, *_level_views(raster, levels)]
    for src, dst in zip(out, out[1:]):
        torch.add(src[..., 0::2, 0::2] + src[..., 0::2, 1::2],
                  src[..., 1::2, 0::2] + src[..., 1::2, 1::2], out=dst)
    return out


@functools.lru_cache(maxsize=256)
def _layout(shape: tuple, levels: int):
    """``(cells, ((shape, strides, offset), ...))``: one buffer of
    ``cells`` that holds levels 1..``levels`` of a raster of ``shape``,
    each contiguous and starting on a multiple of ``_LEVEL_ALIGN`` cells.
    Raises the JAX package's ValueError at the first level with an odd
    side."""
    *batch, h, w = shape
    views, cells = [], 0
    for _ in range(levels):
        if h % 2 or w % 2:
            raise ValueError(
                f"raster {(*batch, h, w)} not 2x2-coarsenable")
        h, w = h // 2, w // 2
        level = (*batch, h, w)
        strides = tuple(math.prod(level[i + 1:]) for i in range(len(level)))
        views.append((level, strides, cells))
        cells += -(-math.prod(level) // _LEVEL_ALIGN) * _LEVEL_ALIGN
    return cells, tuple(views)


def _level_views(raster, levels: int) -> list:
    """Levels 1..``levels`` of ``raster`` to be filled: one
    ``torch.empty`` of its dtype on its device, as contiguous views."""
    cells, views = _layout(tuple(raster.shape), levels)
    buf = torch.empty(cells, dtype=raster.dtype, device=raster.device)
    return [buf.as_strided(*view) for view in views]


def _folded_batch_stride(raster) -> int:
    """The one element stride of the leading dimensions of ``raster``
    read as a single batch dimension (0 where they hold one raster);
    raises where they do not fold into one."""
    dims = [(n, s) for n, s in zip(raster.shape[:-2], raster.stride()[:-2])
            if n != 1]
    for (_, outer), (n, inner) in zip(dims, dims[1:]):
        if outer != inner * n:
            raise ValueError(
                f"the dense pyramid kernel takes leading dimensions that "
                f"fold into one; got shape {tuple(raster.shape)} with "
                f"strides {raster.stride()}")
    return dims[-1][1] if dims else 0


def _launch(raster, levels: int) -> list:
    """Levels 1..``levels`` of ``raster`` from csrc/dense_pyramid.cu, on
    the raster's device and torch's current stream."""
    if not levels:
        return []
    if raster.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the dense pyramid kernel takes int32 and float32 "
                        f"rasters, got {raster.dtype}")
    out = _level_views(raster, levels)
    if raster.numel() == 0:
        return out
    if raster.stride(-1) != 1:
        raise ValueError(f"the dense pyramid kernel takes rasters whose "
                         f"last dimension has stride 1; got strides "
                         f"{raster.stride()}")
    batch_stride = _folded_batch_stride(raster)
    dev = raster.device
    n_batch = math.prod(raster.shape[:-2])
    lib = _build.load("dense_pyramid", _SIGNATURES)
    src, src_batch, src_row = raster, batch_stride, raster.stride(-2)
    done = 0
    with torch.cuda.device(dev):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        while done < levels:
            n = min(KERNEL_LEVELS, levels - done)
            ptrs = (ctypes.c_void_p * n)(
                *(v.data_ptr() for v in out[done:done + n]))
            rc = lib.hm_dense_pyramid(
                src.data_ptr(), _KERNEL_DTYPES[raster.dtype], n_batch,
                src_batch, src_row, src.shape[-2], src.shape[-1], n, ptrs,
                stream)
            if rc != 0:
                raise RuntimeError(f"hm_dense_pyramid failed to launch: "
                                   f"cudaError {rc}")
            _build.count_launch(pyramid_from_raster)
            done += n
            src = out[done - 1]
            src_batch = src.shape[-2] * src.shape[-1]
            src_row = src.shape[-1]
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
        with cascade_stage(timer, "segment_reduce",
                           items=int(uniq.shape[0])):
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
    the contract poisons ``n_unique``). Keys are int64 below the
    sentinel; the cascade packs them in at most 62 bits.

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
    with cascade_stage(timer, "sort", items=n):
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
        with cascade_stage(timer, "segment_reduce", items=n):
            uniq, sums, n_unique = sp.aggregate_sorted_keys_partitioned(
                skeys, cap, sentinel=shifted_sentinel, shift=2 * lvl,
                sorted_weights=sw, weight_bound=weight_bound)
            # Normalize padding to the int64-max sentinel: the level pads
            # with its SHIFTED sentinel, which a `uniq != intmax` mask
            # downstream would let through as phantom cells.
            uniq = torch.where(uniq == shifted_sentinel, SENTINEL, uniq)
        out.append((uniq, sums, n_unique))
    return out
