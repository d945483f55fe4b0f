"""Large-window binning ("partitioned") on a sort and a CUDA run-length kernel.

Port of heatmap_tpu/ops/partitioned.py. The TPU path sorts cell ids
into ``streams`` rows, bins each chunk that lands in one aligned
``block_cells`` block as a one-hot MXU matmul (``_partition_kernel``,
and ``_partition_kernel_weighted`` with the weight in the column
one-hot), sends the other chunks through a bounded scatter tail of
n/``bad_frac`` points and falls back to a full scatter on hostile data.
On Hopper (``csrc/window_partitioned.cu``) one kernel localises the
points to int32 cell ids (dropped points to the sentinel ``hw``), the
wrapper sorts them once with ``torch.sort`` and gathers the weights by
the sort's indices, and a run-length kernel adds each run of equal ids
with a single atomic.

:func:`bin_rowcol_window_partitioned` keeps the JAX function's
arguments, its stream clamp (:func:`clamp_streams`) and its refusals.
``chunk``, ``bad_frac``, ``block_cells`` and ``streams`` shape only the
TPU formulation: they are validated with the JAX package's messages and
do not change the result. Counts are int32 and byte-equal to the
JAX package; weighted sums are float32, byte-equal for integer weights
with per-cell sums below 2^24 and within f32 rounding otherwise (the
JAX package's bound). A CUDA tensor launches the kernel; a CPU tensor
takes the plain PyTorch version (:func:`_plain`). Nothing falls back
from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from heatmap_tpu_torch import _build
from heatmap_tpu_torch.ops.histogram import Window, _plain, localise
from heatmap_tpu_torch.ops.pallas_kernels import (
    _points,
    check_launch,
    check_window,
)

DEFAULT_CHUNK = 1024
#: The JAX package's default stream count (kept for clamp_streams).
DEFAULT_STREAMS = 8
#: Cap on the JAX path's summed per-stream output slabs (bytes).
STREAM_SLAB_BUDGET = 4 << 30
#: Cells per aligned output block of the JAX path (256 x 256).
DEFAULT_BLOCK_CELLS = 1 << 16

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (function, argtypes) of csrc/window_partitioned.cu's C interface.
_SIGNATURES = (
    # row, col, valid, n, row0, col0, height, width, ids, stream
    ("hm_window_cell_ids", (_P, _P, _P, _I64, _I, _I, _I, _I, _P, _P)),
    # sorted_ids, n, hw, out, stream
    ("hm_window_run_length_counts", (_P, _I64, _I, _P, _P)),
    # sorted_ids, sorted_weights, n, hw, out, stream
    ("hm_window_run_length_weighted", (_P, _P, _I64, _I, _P, _P)),
)


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
    """Sort-partitioned binning of pre-projected points into a large window.

    Contract of ops.histogram.bin_rowcol_window: out-of-window and
    invalid points drop. ``weights=None`` counts (int32); ``weights``
    sums them in float32. The raster comes back as ``dtype`` (int32 /
    float32 by default). The JAX path clamps ``streams`` with
    :func:`clamp_streams` to bound its per-stream slabs; the one flat
    sort here has no slabs, so ``streams`` is only validated.

    ``bin_rowcol_window_partitioned.launches`` counts the calls that
    launched the counts kernels, ``.weighted_launches`` the weighted
    ones: each counted call is two kernel launches, ``hm_window_cell_ids``
    and then the run-length kernel.
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
    ``hw`` for dropped ones (out of the window, or invalid). The plain
    PyTorch version of ``hm_window_cell_ids``."""
    r, c, ok = localise(row, col, window, valid)
    # Zero the dropped lanes first, so r * W cannot overflow int32.
    local = torch.where(ok, r, 0) * window.width + torch.where(ok, c, 0)
    return torch.where(ok, local, window.height * window.width)


def _launch(row, col, window, weights, valid):
    lib = _build.load("window_partitioned", _SIGNATURES)
    dev = row.device
    hw = window.height * window.width
    n = row.shape[0]
    out = torch.zeros(window.height, window.width, device=dev,
                      dtype=torch.int32 if weights is None else torch.float32)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    check_launch(lib.hm_window_cell_ids(
        row.data_ptr(), col.data_ptr(),
        None if valid is None else valid.data_ptr(), n, window.row0,
        window.col0, window.height, window.width, ids.data_ptr(), stream),
        "hm_window_cell_ids")
    if weights is None:
        sorted_ids = torch.sort(ids).values
        check_launch(lib.hm_window_run_length_counts(
            sorted_ids.data_ptr(), n, hw, out.data_ptr(), stream),
            "hm_window_run_length_counts")
        bin_rowcol_window_partitioned.launches += 1
        return out
    sorted_ids, order = torch.sort(ids)
    sorted_w = weights[order]
    check_launch(lib.hm_window_run_length_weighted(
        sorted_ids.data_ptr(), sorted_w.data_ptr(), n, hw, out.data_ptr(),
        stream), "hm_window_run_length_weighted")
    bin_rowcol_window_partitioned.weighted_launches += 1
    return out
