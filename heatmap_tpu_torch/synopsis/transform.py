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

The JAX package's device twins (``haar2d_jax``, ``grid_from_rows_jax``)
and the 1D transform of its temporal plane wait for ROADMAP Queue 1
item 5; compaction builds synopses on the host in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["grid_from_rows_np", "haar2d_np", "inv_haar2d_np"]


def _check_grid(grid) -> int:
    n = int(grid.shape[-1])
    if grid.ndim != 2 or grid.shape[0] != n:
        raise ValueError(f"haar2d wants a square 2D grid, got {grid.shape}")
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
