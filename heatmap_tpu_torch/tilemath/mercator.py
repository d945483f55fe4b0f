"""Vectorized Web-Mercator projection (forward and inverse).

Port of heatmap_tpu/tilemath/mercator.py: ``project_points``,
``project_points_np``, the forward and inverse functions
(``mercator_x``/``mercator_y``, ``row_from_latitude``,
``column_from_longitude``, ``latitude_from_row``,
``longitude_from_column``) and ``tile_center_latlon``, as torch
functions that keep their input tensor's device. The behavioural
contract is the reference's scalar math (reference tile.py:16-30),
quirks included:

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


def default_float_dtype():
    """``torch.float64``: the port's tile math runs at the reference's
    CPython-double precision (the JAX package's x64 default)."""
    return torch.float64


def _as_float(x, dtype):
    dtype = dtype or default_float_dtype()
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype)


def mercator_y(latitude, dtype=None):
    """Normalized Mercator y in [0, 1) for latitudes in the mercator range.

    Same operation order as the reference formula (reference
    tile.py:17): ``(1 - log(tan(phi) + sec(phi)) / pi) / 2`` with
    ``phi = lat*pi/180``.
    """
    lat = _as_float(latitude, dtype)
    phi = lat * _PI / 180.0
    return (1.0 - torch.log(torch.tan(phi) + 1.0 / torch.cos(phi)) / _PI) / 2.0


def mercator_x(longitude, dtype=None):
    """Normalized Mercator x in [0, 1); lon == 180 maps to exactly 1.0."""
    lon = _as_float(longitude, dtype)
    return (lon + 180.0) / 360.0


def row_from_latitude(latitude, zoom, dtype=None):
    """Floored tile row at ``zoom`` (float dtype; may be non-finite at
    poles). Matches reference tile.py:16-17; in float64 the rows within
    the error margin of an edge are the host's (see
    :func:`project_points`), so every row is the reference's."""
    return _floored_rows(_as_float(latitude, dtype), zoom)


def column_from_longitude(longitude, zoom, dtype=None):
    """Floored tile column at ``zoom`` (float dtype; 180° -> 2^zoom).
    Matches reference tile.py:20-21."""
    return torch.floor(mercator_x(longitude, dtype) * float(1 << zoom))


def latitude_from_row(row, zoom, dtype=None):
    """North-edge latitude of tile ``row`` at ``zoom`` (reference
    tile.py:24-26): ``atan(sinh(n))`` written as ``atan(0.5*(e^n -
    e^-n))`` with ``n = pi - 2*pi*row/2^zoom``."""
    r = _as_float(row, dtype)
    n = _PI - 2.0 * _PI * r / float(1 << zoom)
    return 180.0 / _PI * torch.atan(0.5 * (torch.exp(n) - torch.exp(-n)))


def longitude_from_column(column, zoom, dtype=None):
    """West-edge longitude of tile ``column`` at ``zoom`` (reference
    tile.py:29-30)."""
    c = _as_float(column, dtype)
    return c / float(1 << zoom) * 360.0 - 180.0


def tile_center_latlon(row, column, zoom, dtype=None):
    """Center (lat, lon) of tiles as the reference computes it: the
    arithmetic mean of the edge latitudes (reference tile.py:45-52), not
    the inverse projection of the Mercator-y midpoint."""
    lat_n = latitude_from_row(row, zoom, dtype)
    r = _as_float(row, dtype)
    lat_s = latitude_from_row(r + 1.0, zoom, dtype)
    lon_w = longitude_from_column(column, zoom, dtype)
    c = _as_float(column, dtype)
    lon_e = longitude_from_column(c + 1.0, zoom, dtype)
    return (lat_n + lat_s) / 2.0, (lon_e + lon_w) / 2.0


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
    frow = _floored_rows(lat, zoom)
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


def _floored_rows(lat, zoom: int):
    """Floored rows of a float tensor of latitudes; in float64 the lanes
    near a row edge are re-derived on the host (:func:`project_points`)."""
    n = float(1 << zoom)
    phi = lat * _PI / 180.0
    t = torch.tan(phi)
    s = 1.0 / torch.cos(phi)
    u = t + s
    log_u = torch.log(u)
    ny = (1.0 - log_u / _PI) / 2.0 * n
    frow = torch.floor(ny)
    if lat.dtype == torch.float64:
        frow = _recheck_row_edges(lat, ny, frow, t, s, u, log_u, n, zoom)
    return frow


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
