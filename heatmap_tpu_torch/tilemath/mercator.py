"""Vectorized Web-Mercator projection in float64.

Port of heatmap_tpu/tilemath/mercator.py (``project_points``,
``project_points_np``). The behavioural contract is the reference's
scalar math (reference tile.py:16-30), quirks included:

- ``floor`` semantics, so negative intermediates round down;
- no pole clamping: |lat| >= 90 gives non-finite rows, and latitudes
  beyond +-85.0511 degrees give rows outside [0, 2^zoom);
- no antimeridian wrap: lon == 180 gives column == 2^zoom.

Out-of-range and non-finite results are reported through the validity
mask of :func:`project_points`, never clamped silently.

Precision: z21 binning needs ~23 bits of Mercator-y fraction, so the
projection always runs in float64; float32 misplaces most z21 points.
The operation order follows the reference formula so the device and
the numpy version agree bit-for-bit wherever the device's ``log``,
``tan`` and ``cos`` round like the host's (they may differ by an ulp,
which moves a point only when it lies within an ulp of a row edge).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Latitude of the square Web-Mercator world edge: atan(sinh(pi)).
MAX_LATITUDE = math.degrees(math.atan(math.sinh(math.pi)))  # 85.05112877980659

_PI = math.pi


def project_points(latitude, longitude, zoom: int):
    """Project point tensors to integer (row, col) at ``zoom`` with validity.

    Returns ``(row, col, valid)``: int32 row/col (they fit int32 for
    every zoom <= 30) and a bool mask of points whose row and column
    are finite and inside [0, 2^zoom). Inputs are cast to float64 on
    their own device; the mask-then-clip-then-cast order matches the
    JAX package, so invalid lanes come out as (0, 0).
    """
    lat = torch.as_tensor(latitude, dtype=torch.float64)
    lon = torch.as_tensor(longitude, dtype=torch.float64, device=lat.device)
    n = float(1 << zoom)
    phi = lat * _PI / 180.0
    y = (1.0 - torch.log(torch.tan(phi) + 1.0 / torch.cos(phi)) / _PI) / 2.0
    frow = torch.floor(y * n)
    fcol = torch.floor((lon + 180.0) / 360.0 * n)
    valid = (
        torch.isfinite(frow)
        & torch.isfinite(fcol)
        & (frow >= 0.0)
        & (frow < n)
        & (fcol >= 0.0)
        & (fcol < n)
    )
    # Zero invalid lanes before the int cast: clip alone keeps NaN, and
    # NaN -> int is backend-dependent garbage.
    frow = torch.where(valid, frow, 0.0)
    fcol = torch.where(valid, fcol, 0.0)
    row = torch.clamp(frow, 0.0, n - 1.0).to(torch.int32)
    col = torch.clamp(fcol, 0.0, n - 1.0).to(torch.int32)
    return row, col, valid


def project_points_np(latitude, longitude, zoom):
    """Host-side numpy-f64 projection: -> (row, col, valid) int64/bool.

    Same operation order as :func:`project_points` and reference
    tile.py:17,21.
    """
    n = 1 << zoom
    lat = np.asarray(latitude, np.float64)
    lon = np.asarray(longitude, np.float64)
    with np.errstate(all="ignore"):
        phi = lat * _PI / 180
        y = (1 - np.log(np.tan(phi) + 1 / np.cos(phi)) / _PI) / 2
        frow = np.floor(y * n)
        fcol = np.floor((lon + 180.0) / 360.0 * n)
    valid = (
        np.isfinite(frow) & np.isfinite(fcol)
        & (frow >= 0) & (frow < n) & (fcol >= 0) & (fcol < n)
    )
    row = np.where(valid, frow, 0).astype(np.int64)
    col = np.where(valid, fcol, 0).astype(np.int64)
    return row, col, valid
