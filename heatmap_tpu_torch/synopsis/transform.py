"""2D Haar transform and the dense count grid of level rows (numpy).

The port's copy of the numpy half of heatmap_tpu/synopsis/transform.py.
The transform is the UNNORMALIZED integer Haar: per 2x2 block
``(a b / c d)`` one scale pass emits

    approx = a + b + c + d        (top-left quadrant)
    dh     = a - b + c - d        (top-right: horizontal detail)
    dv     = a + b - c - d        (bottom-left: vertical detail)
    dd     = a - b - c + d        (bottom-right: diagonal detail)

and recurses on the approx quadrant. The inverse divides by 4 per
pass. Both directions are exact in binary f64 for integer-valued grids
below 2^53, which is what makes a full-coefficient synopsis equal to
the exact level (docs/synopsis.md).

The 1D transform (``haar1d_np``) is the temporal plane's: the same
arrangement along a series' last axis. ``haar2d_torch`` and
``grid_from_rows_torch`` are the device twins of the JAX package's
``haar2d_jax`` and ``grid_from_rows_jax``: plain torch ops on an explicit
device (O(n^2) quadrant adds and one scatter-add; no kernel is
warranted). Compaction builds synopses on the host in both packages, so
no path of either calls the twins.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "haar2d_np", "inv_haar2d_np", "haar2d_torch", "grid_from_rows_torch",
    "grid_from_rows_np", "haar1d_np", "inv_haar1d_np",
]


def _check_grid(grid) -> int:
    n = int(grid.shape[-1])
    if grid.ndim != 2 or grid.shape[0] != n:
        raise ValueError(
            f"haar2d wants a square 2D grid, got {tuple(grid.shape)}")
    if n & (n - 1):
        raise ValueError(f"haar2d wants a power-of-two side, got {n}")
    return n


def haar2d_np(grid: np.ndarray) -> np.ndarray:
    """Full 2D Haar transform of a square power-of-two grid (f64)."""
    n = _check_grid(grid)
    out = np.asarray(grid, np.float64).copy()
    h = n // 2
    while h >= 1:
        a = out[0:2 * h:2, 0:2 * h:2].copy()
        b = out[0:2 * h:2, 1:2 * h:2].copy()
        c = out[1:2 * h:2, 0:2 * h:2].copy()
        d = out[1:2 * h:2, 1:2 * h:2].copy()
        out[:h, :h] = a + b + c + d
        out[:h, h:2 * h] = a - b + c - d
        out[h:2 * h, :h] = a + b - c - d
        out[h:2 * h, h:2 * h] = a - b - c + d
        h //= 2
    return out


def inv_haar2d_np(coeffs: np.ndarray) -> np.ndarray:
    """Inverse of :func:`haar2d_np` (numpy only: the serving decoder)."""
    n = _check_grid(coeffs)
    out = np.asarray(coeffs, np.float64).copy()
    h = 1
    while h < n:
        s = out[:h, :h].copy()
        dh = out[:h, h:2 * h].copy()
        dv = out[h:2 * h, :h].copy()
        dd = out[h:2 * h, h:2 * h].copy()
        out[0:2 * h:2, 0:2 * h:2] = (s + dh + dv + dd) / 4.0
        out[0:2 * h:2, 1:2 * h:2] = (s - dh + dv - dd) / 4.0
        out[1:2 * h:2, 0:2 * h:2] = (s + dh - dv - dd) / 4.0
        out[1:2 * h:2, 1:2 * h:2] = (s - dh - dv + dd) / 4.0
        h *= 2
    return out


def grid_from_rows_np(rows, cols, values, n: int) -> np.ndarray:
    """Scatter-add sparse (row, col, value) cells into a dense f64
    ``(n, n)`` grid. Duplicate cells accumulate."""
    grid = np.zeros((n, n), np.float64)
    np.add.at(grid, (np.asarray(rows, np.int64), np.asarray(cols, np.int64)),
              np.asarray(values, np.float64))
    return grid


def _check_series(series) -> int:
    n = int(series.shape[-1])
    if n & (n - 1) or n == 0:
        raise ValueError(f"haar1d wants a power-of-two length, got {n}")
    return n


def haar1d_np(series: np.ndarray) -> np.ndarray:
    """Full 1D Haar transform along the LAST axis (f64): per pair
    ``(a, b)`` emit ``a + b`` (front half) and ``a - b`` (back half),
    recursing on the front half; leading axes are batch axes. Exact in
    f64 for integer series below 2^53, like the 2D transform."""
    n = _check_series(np.asarray(series))
    out = np.asarray(series, np.float64).copy()
    h = n // 2
    while h >= 1:
        a = out[..., 0:2 * h:2].copy()
        b = out[..., 1:2 * h:2].copy()
        out[..., :h] = a + b
        out[..., h:2 * h] = a - b
        h //= 2
    return out


def inv_haar1d_np(coeffs: np.ndarray) -> np.ndarray:
    """Inverse of :func:`haar1d_np` (divide-by-2 per pass, a power-of-two
    scale, so integer series round-trip bit-exact)."""
    n = _check_series(np.asarray(coeffs))
    out = np.asarray(coeffs, np.float64).copy()
    h = 1
    while h < n:
        s = out[..., :h].copy()
        d = out[..., h:2 * h].copy()
        out[..., 0:2 * h:2] = (s + d) / 2.0
        out[..., 1:2 * h:2] = (s - d) / 2.0
        h *= 2
    return out


def grid_from_rows_torch(rows, cols, values, n: int, valid=None,
                         device=None):
    """Device twin of :func:`grid_from_rows_np`: a float64 ``(n, n)``
    tensor on ``device`` (the inputs' device when None). ``valid`` masks
    pad lanes to weight zero, so bucketed-padded emission arrays give
    the unpadded batch's grid. Indices follow the JAX scatter: a
    negative one counts from the end, one outside ``[-n, n)`` is
    dropped."""
    import torch

    rows = torch.as_tensor(rows, device=device)
    device = rows.device
    rows = rows.to(torch.int64)
    cols = torch.as_tensor(cols, device=device).to(torch.int64)
    values = torch.as_tensor(values, device=device).to(torch.float64)
    rows = torch.where(rows < 0, rows + n, rows)
    cols = torch.where(cols < 0, cols + n, cols)
    keep = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < n)
    if valid is not None:
        keep &= torch.as_tensor(valid, device=device).to(torch.bool)
    grid = torch.zeros(n * n, dtype=torch.float64, device=device)
    grid.index_add_(0, (rows * n + cols)[keep], values[keep])
    return grid.reshape(n, n)


def haar2d_torch(grid, device=None):
    """Device twin of :func:`haar2d_np`: the same arrangement on a
    float64 tensor on ``device`` (the grid's device when None)."""
    import torch

    grid = torch.as_tensor(grid, device=device)
    n = _check_grid(grid)
    out = grid.to(torch.float64).clone()
    h = n // 2
    while h >= 1:
        a = out[0:2 * h:2, 0:2 * h:2].clone()
        b = out[0:2 * h:2, 1:2 * h:2].clone()
        c = out[1:2 * h:2, 0:2 * h:2].clone()
        d = out[1:2 * h:2, 1:2 * h:2].clone()
        out[:h, :h] = a + b + c + d
        out[:h, h:2 * h] = a - b + c - d
        out[h:2 * h, :h] = a + b - c - d
        out[h:2 * h, h:2 * h] = a - b - c + d
        h //= 2
    return out
