"""The window-histogram binning backend ("pallas") on a CUDA kernel.

Port of heatmap_tpu/ops/pallas_kernels.py; the module keeps its name so
that its counterpart is found by path, but its kernel is CUDA C++ for
Hopper (``csrc/window_histogram.cu``), not Pallas. The TPU kernel
(``_histogram_kernel``) bins a chunk of points as the one-hot matmul
``R @ (w * C)`` on the MXU, accumulating in f32; the CUDA kernel adds
each point with an atomic into a shared-memory copy of a band of the
window and flushes the bands to the raster (see the source's notes).

:func:`bin_rowcol_window_pallas` keeps the JAX function's arguments and
refusals. Counts come back as int32 (exact to 2^31 - 1 per cell; the
JAX kernel's f32 raster is exact below 2^24 per cell per call, and the
two agree there), weighted sums as float32. A CUDA tensor launches the
kernel; a CPU tensor takes the plain PyTorch version (:func:`_plain`).
Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from heatmap_tpu_torch import _build
from heatmap_tpu_torch.ops.histogram import Window, _plain
from heatmap_tpu_torch.tilemath import mercator

#: The JAX kernel's points per grid step. The CUDA kernel sizes its own
#: chunks; ``chunk`` is validated and kept for the JAX signature.
DEFAULT_CHUNK = 1024

_INT32_LIMIT = 1 << 31
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (function, argtypes) of csrc/window_histogram.cu's C interface. Every
#: pointer and the stream are c_void_p: a plain int would be cut to 32
#: bits.
_SIGNATURES = (
    # row, col, valid, n, row0, col0, height, width, out, stream
    ("hm_window_histogram_counts", (_P, _P, _P, _I64, _I, _I, _I, _I, _P, _P)),
    # row, col, valid, weights, n, row0, col0, height, width, out, stream
    ("hm_window_histogram_weighted",
     (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _P, _P)),
)


def check_window(window: Window) -> None:
    """The JAX package's int32 cell-id refusal (partitioned.py:390-391)."""
    if window.height * window.width >= _INT32_LIMIT:
        raise ValueError(f"window too large for int32 cell ids: {window}")


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {rc}")


def _points(row, col, weights, valid):
    """Flat contiguous int32 row/col, bool valid and float32 weights on
    the rows' device (valid and weights None when not given)."""
    row = torch.as_tensor(row).reshape(-1).to(torch.int32).contiguous()
    dev = row.device
    col = torch.as_tensor(col, device=dev).reshape(-1).to(
        torch.int32).contiguous()
    if col.shape != row.shape:
        raise ValueError(f"row {tuple(row.shape)} and col {tuple(col.shape)} "
                         "differ in length")
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).reshape(-1).to(
            torch.bool).contiguous()
        if valid.shape != row.shape:
            raise ValueError("valid must have one entry per point")
    if weights is not None:
        weights = torch.as_tensor(weights, device=dev).reshape(-1).to(
            torch.float32).contiguous()
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
    lib = _build.load("window_histogram", _SIGNATURES)
    dev = row.device
    n = row.shape[0]
    out = torch.zeros(window.height, window.width, device=dev,
                      dtype=torch.int32 if weights is None else torch.float32)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    valid_ptr = None if valid is None else valid.data_ptr()
    if weights is None:
        check_launch(lib.hm_window_histogram_counts(
            row.data_ptr(), col.data_ptr(), valid_ptr, n, window.row0,
            window.col0, window.height, window.width, out.data_ptr(), stream),
            "hm_window_histogram_counts")
    else:
        check_launch(lib.hm_window_histogram_weighted(
            row.data_ptr(), col.data_ptr(), valid_ptr, weights.data_ptr(), n,
            window.row0, window.col0, window.height, window.width,
            out.data_ptr(), stream), "hm_window_histogram_weighted")
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
