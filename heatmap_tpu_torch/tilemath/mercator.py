"""Vectorized Web-Mercator projection.

Port of heatmap_tpu/tilemath/mercator.py (``project_points``,
``project_points_np``). The behavioural contract is the reference's
scalar math (reference tile.py:16-30), quirks included:

- ``floor`` semantics, so negative intermediates round down;
- no pole clamping: |lat| >= 90 gives non-finite rows, and latitudes
  beyond +-85.0511 degrees give rows outside [0, 2^zoom);
- no antimeridian wrap: lon == 180 gives column == 2^zoom.

Out-of-range and non-finite results are reported through the validity
mask of :func:`project_points`, never clamped silently.

Precision: z21 binning needs ~23 bits of Mercator-y fraction, so exact
binning runs in float64; float32 is the fast path of dense window
binning (``tiles --no-x64`` and the headline), with the mismatch rates
the JAX package documents for it. The operation order follows the
reference formula, but the vectorised float64 ``log``, ``tan`` and
``cos`` of torch (on the CPU and on CUDA) may round differently from
the host's libm at the last ulp, which moves a point that lies within a
few ulps of a row edge. So the float64 projection re-derives the rows of
exactly those points with the scalar formula on the host
(:func:`project_points`); every other row is already the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from heatmap_tpu_torch.tilemath import tile as _tile

# Latitude of the square Web-Mercator world edge: atan(sinh(pi)).
MAX_LATITUDE = math.degrees(math.atan(math.sinh(math.pi)))  # 85.05112877980659

_PI = math.pi


#: Machine epsilon of float64: the spacing of doubles in [1, 2).
_EPS64 = 2.0 ** -52
#: Safety factor of the row-edge margin over the bound derived below.
_EDGE_MARGIN_FACTOR = 16.0


def _row_edge_margin(t, s, u, log_u, n: float):
    """Per-lane bound on how far the device's ``y * 2^zoom`` can lie from
    the host libm's, times a safety factor.

    With ``t = tan(phi)``, ``s = 1/cos(phi)``, ``u = t + s`` and
    ``y = (1 - log(u)/pi) / 2``: CUDA's double ``tan``, ``cos`` and
    ``log`` are within 2 ulps of the exact value and glibc's within 1
    (torch's CPU versions within 1), so the two sides' results differ by
    at most 3 ulps each. That moves ``t`` by ``3 eps |t|``, ``s`` by
    about ``5 eps |s|`` (the cosine's 3 ulps plus both divisions), ``u``
    by ``3 eps |t| + 5 eps |s| + eps |u|``, and ``log(u)`` by that over
    ``u`` plus ``3 eps |log(u)|``. Scaled by ``n / (2 pi)`` and with the
    last subtraction's rounding, the difference stays below
    ``eps n ((|t| + |s|) / u + |log u| + 2)``. The ``/ u`` term carries
    the cancellation of ``t + s`` at southern latitudes. The margin is
    that bound times ``_EDGE_MARGIN_FACTOR`` (over 8x the bound);
    measured on torch's CPU functions, the largest difference is under
    a quarter of the unscaled bound.
    """
    return (_EDGE_MARGIN_FACTOR * _EPS64 * n) * (
        (t.abs() + s.abs()) / u.abs() + log_u.abs() + 2.0)


def _host_row(latitude: float, zoom: int) -> float:
    """The reference's row as a float; NaN where CPython's ``math``
    refuses the point (``log`` of a non-positive sum, ``floor`` of an
    infinity), which the validity mask then drops."""
    try:
        return float(_tile._row_from_latitude(latitude, zoom))
    except (ValueError, OverflowError):
        return math.nan


def project_points(latitude, longitude, zoom: int, dtype=torch.float64):
    """Project point tensors to integer (row, col) at ``zoom`` with validity.

    Returns ``(row, col, valid)``: int32 row/col (they fit int32 for
    every zoom <= 30) and a bool mask of points whose row and column
    are finite and inside [0, 2^zoom). Inputs are cast to ``dtype`` on
    their own device; the mask-then-clip-then-cast order matches the
    JAX package, so invalid lanes come out as (0, 0).

    ``dtype=torch.float64`` (the default) gives the reference's rows
    exactly: lanes whose ``y * 2^zoom`` lies within
    :func:`_row_edge_margin` of an integer are recomputed with the
    scalar formula on the host and written back. That is part of the
    projection on every device (one device-to-host sync per call);
    ``project_points.rechecked`` counts the lanes it recomputed.
    ``torch.float32`` is the fast path and gets no recheck; its rows
    are held to the JAX package's documented f32 mismatch rates.
    """
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype must be torch.float64 or torch.float32, "
                         f"got {dtype}")
    lat = torch.as_tensor(latitude, dtype=dtype)
    lon = torch.as_tensor(longitude, dtype=dtype, device=lat.device)
    n = float(1 << zoom)
    phi = lat * _PI / 180.0
    t = torch.tan(phi)
    s = 1.0 / torch.cos(phi)
    u = t + s
    log_u = torch.log(u)
    ny = (1.0 - log_u / _PI) / 2.0 * n
    frow = torch.floor(ny)
    if dtype == torch.float64:
        frow = _recheck_row_edges(lat, ny, frow, t, s, u, log_u, n, zoom)
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


project_points.rechecked = 0


def _recheck_row_edges(lat, ny, frow, t, s, u, log_u, n, zoom):
    """``frow`` with the lanes near a row edge replaced by the host's
    scalar rows (see :func:`project_points`)."""
    margin = _row_edge_margin(t, s, u, log_u, n)
    # A NaN margin (u <= 0) flags the lane too.
    near = torch.isfinite(ny) & ~((ny - torch.round(ny)).abs() > margin)
    idx = torch.nonzero(near).squeeze(1)
    k = int(idx.shape[0])
    project_points.rechecked += k
    if k == 0:
        return frow
    host = [_host_row(x, zoom) for x in lat[idx].tolist()]
    frow[idx] = torch.tensor(host, dtype=frow.dtype, device=frow.device)
    return frow


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
