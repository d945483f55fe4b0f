"""Morton (Z-order) codes for tile keys.

Port of heatmap_tpu/tilemath/morton.py. The pyramid parent of a Morton
code is ``code >> 2`` and the shift preserves sort order, so one sort of
detail-zoom codes serves every cascade level. Two widths:

- int32 codes hold zooms <= 15 (2 x 15 = 30 bits), the z0-z15 pyramid;
- int64 codes hold zooms <= 29, which covers the z21 detail grid.

The numpy helpers at the bottom are 64-bit, and the range-ownership
helpers (``morton_range_shards_np``, ``split_boundary_codes_np``) are
the one convention the partition planner and the write plane's router
share.
"""

from __future__ import annotations

import numpy as np
import torch

#: The widest zoom each code width holds.
ZOOM_LIMIT = {torch.int32: 15, torch.int64: 29}


def _part1by1_32(x):
    """Spread the low 16 bits of int32 ``x`` into the even bit positions."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _compact1by1_32(x):
    """Inverse of :func:`_part1by1_32`."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def _part1by1_64(x):
    """Spread the low 32 bits of int64 ``x`` into the even bit positions."""
    x = x & 0x00000000FFFFFFFF
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    x = (x | (x << 1)) & 0x5555555555555555
    return x


def _compact1by1_64(x):
    """Inverse of :func:`_part1by1_64`."""
    x = x & 0x5555555555555555
    x = (x | (x >> 1)) & 0x3333333333333333
    x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF0000FFFF
    x = (x | (x >> 16)) & 0x00000000FFFFFFFF
    return x


def morton_encode(row, col, dtype=torch.int32, zoom: int | None = None):
    """Interleave (row, col) tensors into Z-order codes; row occupies
    the odd bits.

    ``dtype=torch.int32`` holds zooms <= 15, ``torch.int64`` zooms <=
    29. Coordinates past the dtype's range would be bit-truncated into
    aliased codes, so pass the static ``zoom`` whenever it is known to
    get a loud error instead.
    """
    if dtype not in ZOOM_LIMIT:
        raise ValueError(f"morton codes are int32 or int64, got {dtype}")
    if zoom is not None and zoom > ZOOM_LIMIT[dtype]:
        name = str(dtype).rpartition(".")[2]
        raise ValueError(
            f"morton {name} codes hold zooms <= {ZOOM_LIMIT[dtype]}, "
            f"got zoom={zoom}; use a wider dtype")
    r = torch.as_tensor(row).to(dtype)
    c = torch.as_tensor(col).to(dtype)
    part = _part1by1_32 if dtype == torch.int32 else _part1by1_64
    return (part(r) << 1) | part(c)


def morton_decode(code):
    """Z-order code tensor -> (row, col), dtype-matched to the code."""
    code = torch.as_tensor(code)
    if code.dtype == torch.int32:
        return _compact1by1_32(code >> 1), _compact1by1_32(code)
    code = code.to(torch.int64)
    return _compact1by1_64(code >> 1), _compact1by1_64(code)


def morton_parent(code, levels: int = 1):
    """The ancestor code ``levels`` zooms coarser: a right shift by
    ``2 * levels``, which keeps sorted codes sorted."""
    return code >> (2 * levels)


def morton_encode_np(row, col) -> np.ndarray:
    """Numpy 64-bit Morton encode (zooms <= 29, like the int64 path)."""

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


def morton_range_shards_np(splits, codes) -> np.ndarray:
    """Shard index per detail code under sorted split codes.

    A code belongs to shard ``k`` iff exactly ``k`` splits are <= it
    (``searchsorted(side="right")``): a split code opens the range to
    its right. The planner and the write plane's router must agree on
    this or boundary tiles get counted twice.
    """
    return np.searchsorted(
        np.asarray(splits, np.int64), np.asarray(codes, np.int64),
        side="right").astype(np.int32)


def split_boundary_codes_np(splits, levels: int) -> np.ndarray:
    """Ancestor codes ``levels`` zooms coarser whose tile straddles a split.

    A tile ``levels`` above detail covers the detail range ``[c << 2L,
    (c+1) << 2L)``; a split ``s`` falls strictly inside it iff ``s >> 2L
    == c`` and ``s % 4^L != 0``. At ``levels == 0`` no split can be
    strictly inside one code, so the set is empty.
    """
    s = np.unique(np.asarray(splits, np.int64))
    if levels <= 0 or s.size == 0:
        return np.empty(0, np.int64)
    block = np.int64(1) << np.int64(2 * levels)
    inner = s[(s % block) != 0]
    return np.unique(inner >> np.int64(2 * levels))
