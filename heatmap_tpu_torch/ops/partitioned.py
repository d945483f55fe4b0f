"""Large-window binning ("partitioned") on hand-written CUDA kernels.

Port of heatmap_tpu/ops/partitioned.py. The TPU path sorts cell ids
into ``streams`` rows, bins each chunk that lands in one aligned
``block_cells`` block as a one-hot MXU matmul (``_partition_kernel``,
and ``_partition_kernel_weighted`` with the weight in the column
one-hot), sends the other chunks through a bounded scatter tail of
n/``bad_frac`` points and falls back to a full scatter on hostile data.
On Hopper:

- counts and weights (``csrc/window_bucketed.cu``) group the points by
  aligned sub-block of :data:`SUB_SIDE` x :data:`SUB_SIDE` cells, never
  by cell: a count pass, a scan, a scatter of each point's local cell
  offset (and its weight) into its sub-block's bucket, and one block per
  work item of at most :data:`ITEM_POINTS` points that bins it in
  shared memory. No sort, no gather. :func:`plan_counts` sizes the
  grids and the one scratch allocation on the host.

:func:`bin_rowcol_window_partitioned` keeps the JAX function's
arguments, its stream clamp (:func:`clamp_streams`) and its refusals.
``chunk``, ``bad_frac``, ``block_cells`` and ``streams`` shape only the
TPU formulation: they are validated with the JAX package's messages and
do not change the result. Counts are int32 and byte-equal to the
JAX package; weighted sums are float32, byte-equal for integer weights
with per-cell sums below 2^24 and within f32 rounding otherwise (the
JAX package's bound; the kernel's float atomics add in an order that
changes from run to run). A CUDA tensor launches the kernels; a CPU
tensor takes the plain PyTorch version (:func:`_plain`). Nothing falls
back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from heatmap_tpu_torch import _build
from heatmap_tpu_torch.ops.histogram import Window, _plain, localise
from heatmap_tpu_torch.ops.pallas_kernels import (
    _points,
    check_launch,
    check_window,
    raw_stream,
)

DEFAULT_CHUNK = 1024
#: The JAX package's default stream count (kept for clamp_streams).
DEFAULT_STREAMS = 8
#: Cap on the JAX path's summed per-stream output slabs (bytes).
STREAM_SLAB_BUDGET = 4 << 30
#: Cells per aligned output block of the JAX path (256 x 256).
DEFAULT_BLOCK_CELLS = 1 << 16

#: Side of the aligned sub-blocks of the bucketed kernels: a 128 x 128
#: int32 or float32 sub-block (64 KiB) fits one block's shared memory.
SUB_SIDE = 128
#: Most buckets (sub-blocks) one block of the count and scatter passes
#: holds in shared memory (48 KiB); wider windows take several groups.
GROUP_BUCKETS = 12288
#: Points per chunk of the count and scatter passes: larger chunks mean
#: fewer per-chunk flushes (global atomics) of the bucket counts ...
CHUNK_POINTS = 1 << 15
#: ... but at least MIN_CHUNKS chunks (two blocks an SM) while chunks
#: keep MIN_CHUNK_POINTS points, so small batches fill the card.
MIN_CHUNKS = 264
MIN_CHUNK_POINTS = 2048
#: Cap on the per-chunk bucket offsets (chunks x buckets int32 words).
MAX_CHUNK_BASE = 1 << 24
#: Most points of one work item of the binning pass.
ITEM_POINTS = 1 << 14
_GRID_Y_MAX = 65535
_INT32_MAX = (1 << 31) - 1

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GEOMETRY = (_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I64, _I, _I64)
#: (function, argtypes) of csrc/window_bucketed.cu's C interface.
_SIGNATURES = (
    # row, col, valid, n, row0, col0, height, width, side, sub_cols,
    # buckets, group_buckets, groups, chunks, per_chunk, item_points,
    # items_max, bucket_count, chunk_base, bucket_start, item_start,
    # cells, out, stream
    ("hm_window_bucketed_counts",
     (_P, _P, _P, _I64, *_GEOMETRY, _P, _P, _P, _P, _P, _P, _P)),
    # row, col, valid, weights, n, the same geometry and scratch, then
    # wcells, out, stream
    ("hm_window_bucketed_weighted",
     (_P, _P, _P, _P, _I64, *_GEOMETRY, _P, _P, _P, _P, _P, _P, _P, _P)),
)


@dataclasses.dataclass(frozen=True)
class CountsPlan:
    """Grids and scratch of the bucketed kernels (counts and weights) for
    one call.

    The window is cut into ``sub_rows`` x ``sub_cols`` sub-blocks of
    SUB_SIDE cells a side (the last row and column ragged where the
    window's sides are not multiples of it); bucket ``b`` is sub-block
    ``(b // sub_cols, b % sub_cols)``. The count and scatter passes run
    on a (``groups``, ``chunks``) grid, each block on ``per_chunk``
    points and the buckets of one group; the binning pass on
    ``items_max`` blocks, an upper bound of the work items.

    All scratch is one int32 allocation: the bucket totals, the
    per-chunk offsets, the bucket and item starts, then the local cell
    offsets at :attr:`cells_offset` and, for weights, the scattered
    weights at :meth:`weights_offset`, each 16-byte aligned.
    """

    sub_rows: int
    sub_cols: int
    groups: int
    chunks: int
    per_chunk: int
    items_max: int

    @property
    def buckets(self) -> int:
        return self.sub_rows * self.sub_cols

    @property
    def group_buckets(self) -> int:
        return -(-self.buckets // self.groups)

    @property
    def cells_offset(self) -> int:
        """int32 words of scratch before the local cell offsets: the
        bucket totals, the per-chunk offsets, then the bucket and item
        starts (buckets + 1 each), rounded up to 16 bytes."""
        words = (self.buckets + self.chunks * self.buckets
                 + 2 * (self.buckets + 1))
        return -(-words // 4) * 4

    def weights_offset(self, n: int) -> int:
        """int32 words before the scattered weights: the local cell
        offsets take 2 bytes a point, and 8 more cells of slack for the
        binning pass's aligned 16-byte loads, rounded up to 16 bytes."""
        return self.cells_offset + -(-(n + 8) // 8) * 4

    def scratch_words(self, n: int, weighted: bool = False) -> int:
        """All int32 words of scratch for ``n`` points; weights take 4
        bytes a point with the cells' 8 elements of slack."""
        return self.weights_offset(n) + (n + 8 if weighted else 0)


@functools.lru_cache(maxsize=64)
def plan_counts(window: Window, n: int) -> CountsPlan:
    """The bucketed kernels' plan for ``n > 0`` points (cached: the
    wrapper is host-bound at small shapes)."""
    if not 0 < n <= _INT32_MAX:
        raise ValueError(f"{n} points: the counts kernel takes 1 to 2^31 - 1")
    sub_rows = -(-window.height // SUB_SIDE)
    sub_cols = -(-window.width // SUB_SIDE)
    buckets = sub_rows * sub_cols
    groups = -(-buckets // GROUP_BUCKETS)
    chunks = max(-(-n // CHUNK_POINTS),
                 min(-(-n // MIN_CHUNK_POINTS), MIN_CHUNKS))
    chunks = max(1, min(chunks, _GRID_Y_MAX, MAX_CHUNK_BASE // buckets))
    # Chunks start on multiples of 4 points, for the kernel's 16-byte
    # loads of 4 rows or columns.
    per_chunk = -(-n // (4 * chunks)) * 4
    # Each bucket of c points makes ceil(c / ITEM_POINTS) items, at most
    # c / ITEM_POINTS + 1, and the buckets hold at most n points.
    items_max = -(-n // ITEM_POINTS) + buckets
    return CountsPlan(sub_rows, sub_cols, groups, chunks, per_chunk,
                      items_max)


def clamp_streams(streams: int, window: Window,
                  block_cells: int = DEFAULT_BLOCK_CELLS) -> int:
    """Largest stream count <= ``streams`` whose summed output slabs
    fit STREAM_SLAB_BUDGET for this window (always >= 1)."""
    hw = window.height * window.width
    slab_bytes = -(-hw // block_cells) * block_cells * 4
    return max(1, min(streams, STREAM_SLAB_BUDGET // max(slab_bytes, 1)))


def _check_geometry(window: Window, chunk: int, bad_frac: int,
                    block_cells: int, streams: int) -> None:
    """The JAX package's refusals, in its order (partitioned.py:388-399),
    plus the positive ``chunk`` and ``bad_frac`` it divides by."""
    check_window(window)
    side = 1 << (block_cells.bit_length() // 2)
    if side * side != block_cells or side < 64:
        raise ValueError(
            f"block_cells must be an even power of two >= 4096 "
            f"(a square side of >= 64 lanes), got {block_cells}"
        )
    if streams < 1:
        raise ValueError(f"streams must be >= 1, got {streams}")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    if not isinstance(bad_frac, int) or bad_frac < 1:
        raise ValueError(f"bad_frac must be a positive int, got {bad_frac!r}")


def bin_rowcol_window_partitioned(
    row,
    col,
    window: Window,
    weights=None,
    valid=None,
    chunk: int = DEFAULT_CHUNK,
    bad_frac: int = 128,
    dtype=None,
    block_cells: int = DEFAULT_BLOCK_CELLS,
    streams: int = DEFAULT_STREAMS,
):
    """Partitioned binning of pre-projected points into a large window.

    Contract of ops.histogram.bin_rowcol_window: out-of-window and
    invalid points drop. ``weights=None`` counts (int32); ``weights``
    sums them in float32. The raster comes back as ``dtype`` (int32 /
    float32 by default). The JAX path clamps ``streams`` with
    :func:`clamp_streams` to bound its per-stream slabs; the kernels
    here have no slabs, so ``streams`` is only validated.

    ``bin_rowcol_window_partitioned.launches`` counts the calls that
    launched the bucketed counts kernels (their four passes),
    ``.weighted_launches`` the calls that launched the weighted ones.
    """
    if dtype is None:
        dtype = torch.int32 if weights is None else torch.float32
    _check_geometry(window, chunk, bad_frac, block_cells, streams)
    row, col, weights, valid = _points(row, col, weights, valid)
    dev = row.device
    if dev.type == "cpu":
        raster = _plain(row, col, window, weights, valid)
    elif dev.type == "cuda":
        with torch.cuda.device(dev):
            raster = _launch(row, col, window, weights, valid)
    else:
        raise ValueError(f"unsupported device {dev}")
    return raster.to(dtype)


bin_rowcol_window_partitioned.launches = 0
bin_rowcol_window_partitioned.weighted_launches = 0


def cell_ids(row, col, window: Window, valid=None):
    """int32 cell ids ``r * W + c`` of the points, with the sentinel
    ``hw`` for dropped ones (out of the window, or invalid): the flat
    index that ``chip_smoke.py`` hands ``torch.bincount``, its library
    yardstick for the window kernels."""
    r, c, ok = localise(row, col, window, valid)
    # Zero the dropped lanes first, so r * W cannot overflow int32.
    local = torch.where(ok, r, 0) * window.width + torch.where(ok, c, 0)
    return torch.where(ok, local, window.height * window.width)


def _launch(row, col, window, weights, valid):
    dev = row.device
    n = row.shape[0]
    dtype = torch.int32 if weights is None else torch.float32
    if n == 0:
        return torch.zeros(window.height, window.width, device=dev,
                           dtype=dtype)
    lib = _build.load("window_bucketed", _SIGNATURES)
    plan = plan_counts(window, n)
    # The kernels zero the raster and the bucket totals themselves.
    out = torch.empty(window.height, window.width, device=dev, dtype=dtype)
    scratch = torch.empty(plan.scratch_words(n, weights is not None),
                          dtype=torch.int32, device=dev)
    bucket_count = scratch.data_ptr()
    chunk_base = bucket_count + 4 * plan.buckets
    bucket_start = chunk_base + 4 * plan.chunks * plan.buckets
    item_start = bucket_start + 4 * (plan.buckets + 1)
    cells = bucket_count + 4 * plan.cells_offset
    stream = raw_stream(dev)
    valid_ptr = None if valid is None else valid.data_ptr()
    geometry = (window.row0, window.col0, window.height, window.width,
                SUB_SIDE, plan.sub_cols, plan.buckets, plan.group_buckets,
                plan.groups, plan.chunks, plan.per_chunk, ITEM_POINTS,
                plan.items_max, bucket_count, chunk_base, bucket_start,
                item_start, cells)
    if weights is None:
        check_launch(lib.hm_window_bucketed_counts(
            row.data_ptr(), col.data_ptr(), valid_ptr, n, *geometry,
            out.data_ptr(), stream), "hm_window_bucketed_counts")
        bin_rowcol_window_partitioned.launches += 1
    else:
        wcells = bucket_count + 4 * plan.weights_offset(n)
        check_launch(lib.hm_window_bucketed_weighted(
            row.data_ptr(), col.data_ptr(), valid_ptr, weights.data_ptr(), n,
            *geometry, wcells, out.data_ptr(), stream),
            "hm_window_bucketed_weighted")
        bin_rowcol_window_partitioned.weighted_launches += 1
    return out
