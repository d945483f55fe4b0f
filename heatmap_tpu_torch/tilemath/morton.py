"""64-bit Morton (Z-order) codes for tile keys.

Port of the int64 paths of heatmap_tpu/tilemath/morton.py. The pyramid
parent of a Morton code is ``code >> 2`` and the shift preserves sort
order, so one sort of detail-zoom codes serves every cascade level.
int64 codes hold zooms <= 29, which covers the z21 detail grid.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_ZOOM = 29


def _part1by1_64(x):
    """Spread the low 32 bits of int64 ``x`` into the even bit positions."""
    x = x & 0x00000000FFFFFFFF
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    x = (x | (x << 1)) & 0x5555555555555555
    return x


def morton_encode(row, col, zoom: int | None = None):
    """Interleave (row, col) tensors into int64 Z-order codes; row
    occupies the odd bits. Pass the static ``zoom`` to get a loud error
    instead of bit-truncated, aliased codes past zoom 29."""
    if zoom is not None and zoom > MAX_ZOOM:
        raise ValueError(
            f"morton int64 codes hold zooms <= {MAX_ZOOM}, got zoom={zoom}; "
            "use a wider dtype"
        )
    r = torch.as_tensor(row).to(torch.int64)
    c = torch.as_tensor(col).to(torch.int64)
    return (_part1by1_64(r) << 1) | _part1by1_64(c)


def morton_encode_np(row, col) -> np.ndarray:
    """Numpy 64-bit Morton encode (zooms <= 29)."""

    def part(x):
        x = np.asarray(x, np.uint64) & np.uint64(0xFFFFFFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
        return x

    return ((part(row) << np.uint64(1)) | part(col)).astype(np.int64)


def _morton_decode_np_pure(code) -> tuple[np.ndarray, np.ndarray]:
    """Numpy 64-bit Morton decode -> (row, col) int32.

    int32 always suffices: a 64-bit code interleaves at most 31 bits
    per axis, so row/col < 2^31.
    """
    code = np.asarray(code, np.uint64)

    def compact(x):
        x &= np.uint64(0x5555555555555555)
        x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
        x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
        return x

    return (
        compact(code >> np.uint64(1)).astype(np.int32),
        compact(code).astype(np.int32),
    )


def morton_decode_np(code) -> tuple[np.ndarray, np.ndarray]:
    """Numpy 64-bit Morton decode -> (row, col) int32; bulk arrays go
    through the native library's threaded decode where it loads."""
    code = np.asarray(code, np.uint64)
    if code.ndim == 1 and code.size > 100_000:
        # Lazy import: native imports the pipeline package.
        from heatmap_tpu_torch import native

        if native.available():
            _, _, row, col = native.decode_keys(
                code.astype(np.int64, copy=False), 0, morton_only=True)
            return row, col
    return _morton_decode_np_pure(code)
