"""The window-histogram binning backend ("pallas") on a CUDA kernel.

Port of heatmap_tpu/ops/pallas_kernels.py; the module keeps its name so
that its counterpart is found by path, but its kernel is CUDA C++ for
Hopper (``csrc/window_histogram.cu``), not Pallas. The TPU kernel
(``_histogram_kernel``) keeps one f32 copy of the window in VMEM and
bins each chunk of points into it as the one-hot matmul ``R @ (w * C)``
on the MXU. The CUDA kernel cuts the window into bands of
:data:`SLICE_BYTES` (two at 256 x 256 cells), one in the shared memory
of each block of a group of neighbouring blocks; the blocks of a group
walk the same points and each adds its band's points with shared-memory
atomics; each band is zeroed once and flushed to the raster once (see
the source's notes). :func:`plan_histogram` sizes the bands and the grid
on the host.

:func:`bin_rowcol_window_pallas` keeps the JAX function's arguments and
refusals. Counts come back as int32 (exact to 2^31 - 1 per cell; the
JAX kernel's f32 raster is exact below 2^24 per cell per call, and the
two agree there), weighted sums as float32. A CUDA tensor launches the
kernel; a CPU tensor takes the plain PyTorch version (:func:`_plain`).
Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from heatmap_tpu_torch import _build
from heatmap_tpu_torch.ops.histogram import Window, _plain
from heatmap_tpu_torch.tilemath import mercator

#: The JAX kernel's points per grid step. The CUDA kernel sizes its own
#: grid; ``chunk`` is validated and kept for the JAX signature.
DEFAULT_CHUNK = 1024

#: Bytes of the window that one block holds in shared memory: a
#: 256 x 256 int32 or float32 window takes two bands.
SLICE_BYTES = 128 << 10
#: Most bands (each reads every point); a window of more (only an
#: explicit backend="pallas" sends one) takes the kernel's global-atomic
#: build.
MAX_BANDS = 8
#: Blocks the grid puts on each SM (one fits, with 128 KiB of shared
#: memory and 1024 threads): one private copy per SM, zeroed and flushed
#: once.
BLOCKS_PER_SM = 1
#: Points one block takes per step (1024 threads, 4 points each).
STEP_POINTS = 4096

_INT32_LIMIT = 1 << 31
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (function, argtypes) of csrc/window_histogram.cu's C interface. Every
#: pointer and the stream are c_void_p: a plain int would be cut to 32
#: bits.
_SIGNATURES = (
    # row, col, valid, n, row0, col0, height, width, bands, slice_shift,
    # blocks, out, stream
    ("hm_window_histogram_counts",
     (_P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I64, _P, _P)),
    # row, col, valid, weights, n, row0, col0, height, width, bands,
    # slice_shift, blocks, out, stream
    ("hm_window_histogram_weighted",
     (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I64, _P, _P)),
)


@dataclasses.dataclass(frozen=True)
class HistogramPlan:
    """Bands and grid of the histogram kernel for one call.

    The window's ``height * width`` cells are cut into ``bands`` slices
    of ``2 ** slice_shift`` cells (the last one ragged), one in the
    shared memory of each block of a group; ``blocks`` blocks in all, a
    multiple of ``bands``. ``bands == 0`` is the global-atomic build (no
    slices).
    """

    bands: int
    slice_shift: int
    blocks: int


@functools.lru_cache(maxsize=256)
def plan_histogram(window: Window, n: int, sms: int) -> HistogramPlan:
    """The histogram kernel's plan for ``n > 0`` points on a card of
    ``sms`` SMs: the fewest SLICE_BYTES bands that hold the window, and
    BLOCKS_PER_SM blocks an SM, or fewer groups where the points take
    fewer steps. Fewer groups would flush fewer cells when the points
    are few for the window's cells, but each group's walk is the larger
    cost: on an H100 every halving of the groups measured slower, at
    about 1e6 points on 65,536 cells too (tools/torch_histogram_plans.py,
    PERF.md)."""
    if n < 1 or sms < 1:
        raise ValueError(f"no histogram plan for {n} points on {sms} SMs")
    cells = window.height * window.width
    bands = -(-cells // (SLICE_BYTES // 4))
    steps = -(-n // STEP_POINTS)
    if bands > MAX_BANDS:
        return HistogramPlan(0, 0, max(1, min(sms * BLOCKS_PER_SM, steps)))
    slice_shift = (-(-cells // bands) - 1).bit_length()
    walkers = max(1, min(sms * BLOCKS_PER_SM // bands, steps))
    return HistogramPlan(bands, slice_shift, walkers * bands)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_window(window: Window) -> None:
    """The JAX package's int32 cell-id refusal (partitioned.py:390-391)."""
    if window.height * window.width >= _INT32_LIMIT:
        raise ValueError(f"window too large for int32 cell ids: {window}")


def raw_stream(dev) -> int:
    """The handle of ``dev``'s current CUDA stream, read without building
    a ``torch.cuda.Stream`` object, which costs a window kernel's wrapper
    a measurable share of its host time at small shapes."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {rc}")


def _flat(x, dtype, device=None):
    """``x`` as a flat contiguous ``dtype`` tensor (on ``device``); a
    tensor that is one already comes back as it is, with no dispatcher
    call (the window kernels' wrappers are host-bound at small shapes)."""
    if (isinstance(x, torch.Tensor) and x.dtype == dtype and x.dim() == 1
            and x.is_contiguous() and (device is None or x.device == device)):
        return x
    return torch.as_tensor(x, device=device).reshape(-1).to(
        dtype).contiguous()


def _points(row, col, weights, valid):
    """Flat contiguous int32 row/col, bool valid and float32 weights on
    the rows' device (valid and weights None when not given)."""
    row = _flat(row, torch.int32)
    dev = row.device
    col = _flat(col, torch.int32, dev)
    if col.shape != row.shape:
        raise ValueError(f"row {tuple(row.shape)} and col {tuple(col.shape)} "
                         "differ in length")
    if valid is not None:
        valid = _flat(valid, torch.bool, dev)
        if valid.shape != row.shape:
            raise ValueError("valid must have one entry per point")
    if weights is not None:
        weights = _flat(weights, torch.float32, dev)
        if weights.shape != row.shape:
            raise ValueError("weights must have one entry per point")
    return row, col, weights, valid


def bin_rowcol_window_pallas(row, col, window: Window, weights=None,
                             valid=None, chunk: int = DEFAULT_CHUNK,
                             onehot_dtype=None):
    """Window histogram: pre-projected points -> (H, W) raster.

    Same contract as ops.histogram.bin_rowcol_window: out-of-window and
    invalid points drop. Counts (``weights=None``) come back as int32,
    weighted sums as float32. ``onehot_dtype`` is the JAX kernel's
    operand type; the CUDA kernel has no one-hots, but a weighted call
    with a reduced-precision one is refused as the JAX package refuses
    it. ``bin_rowcol_window_pallas.launches`` counts the calls that
    launched the CUDA kernel.
    """
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    if (weights is not None and onehot_dtype is not None
            and onehot_dtype != torch.float32):
        raise ValueError(
            "weighted binning requires f32 one-hots (bf16 would round "
            "the weights); leave onehot_dtype unset"
        )
    check_window(window)
    row, col, weights, valid = _points(row, col, weights, valid)
    dev = row.device
    if dev.type == "cpu":
        return _plain(row, col, window, weights, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with torch.cuda.device(dev):
        return _launch(row, col, window, weights, valid)


bin_rowcol_window_pallas.launches = 0


def _launch(row, col, window, weights, valid):
    dev = row.device
    n = row.shape[0]
    dtype = torch.int32 if weights is None else torch.float32
    if n == 0:
        return torch.zeros(window.height, window.width, device=dev,
                           dtype=dtype)
    # The kernel's entry point zeroes the raster.
    out = torch.empty(window.height, window.width, device=dev, dtype=dtype)
    lib = _build.load("window_histogram", _SIGNATURES)
    plan = plan_histogram(window, n, _sms(dev.index))
    stream = raw_stream(dev)
    valid_ptr = None if valid is None else valid.data_ptr()
    geometry = (window.row0, window.col0, window.height, window.width,
                plan.bands, plan.slice_shift, plan.blocks)
    if weights is None:
        check_launch(lib.hm_window_histogram_counts(
            row.data_ptr(), col.data_ptr(), valid_ptr, n, *geometry,
            out.data_ptr(), stream), "hm_window_histogram_counts")
    else:
        check_launch(lib.hm_window_histogram_weighted(
            row.data_ptr(), col.data_ptr(), valid_ptr, weights.data_ptr(), n,
            *geometry, out.data_ptr(), stream), "hm_window_histogram_weighted")
    bin_rowcol_window_pallas.launches += 1
    return out


def bin_points_window_pallas(latitude, longitude, window: Window,
                             weights=None, valid=None,
                             proj_dtype=torch.float64,
                             chunk: int = DEFAULT_CHUNK):
    """Projection + the window-histogram kernel (bin_points_window's
    "pallas" path called directly)."""
    rowf, colf, proj_valid = mercator.project_points(
        latitude, longitude, window.zoom, dtype=proj_dtype
    )
    if valid is not None:
        proj_valid = proj_valid & torch.as_tensor(valid,
                                                  device=proj_valid.device)
    return bin_rowcol_window_pallas(
        rowf, colf, window, weights=weights, valid=proj_valid, chunk=chunk,
    )
