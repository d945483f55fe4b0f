"""Dense window-raster histograms: points -> per-tile counts.

Port of heatmap_tpu/ops/histogram.py. A :class:`Window` is a static,
axis-aligned block of the global tile grid at one zoom; points are
projected, localised and added into an (H, W) raster. Counts accumulate
in int32 (``weights=None``) and weighted sums in float32 by default.

Backends keep the JAX package's names, so the flags stay the same:

- ``"xla"``: the plain PyTorch scatter (:func:`_scatter_window`);
- ``"pallas"``: the CUDA window-histogram kernel
  (ops/pallas_kernels.py, ``csrc/window_histogram.cu``);
- ``"partitioned"``: the bucketed CUDA kernels for large windows
  (ops/partitioned.py, ``csrc/window_bucketed.cu``);
- ``"auto"``: by device and window size (:func:`_pick_backend`).

On a CPU tensor the two kernel backends run their plain PyTorch
versions; on a CUDA tensor they launch their kernels or raise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from heatmap_tpu_torch.tilemath import mercator
from heatmap_tpu_torch.tilemath import tile as _tile
from heatmap_tpu_torch.utils.trace import stage_block, stage_span

BACKENDS = ("auto", "xla", "pallas", "partitioned")


@dataclasses.dataclass(frozen=True)
class Window:
    """A static tile-grid window at one zoom.

    Covers rows [row0, row0+height) x cols [col0, col0+width) at ``zoom``.
    """

    zoom: int
    row0: int
    col0: int
    height: int
    width: int

    def __post_init__(self):
        n = 1 << self.zoom
        if self.height <= 0 or self.width <= 0:
            raise ValueError(f"window has empty extent: {self}")
        if not (0 <= self.row0 and self.row0 + self.height <= n):
            raise ValueError(f"window rows outside grid at z{self.zoom}: {self}")
        if not (0 <= self.col0 and self.col0 + self.width <= n):
            raise ValueError(f"window cols outside grid at z{self.zoom}: {self}")

    @property
    def shape(self):
        return (self.height, self.width)

    def aligned_to(self, levels: int) -> bool:
        """True if the window sits on 2^levels tile boundaries, so a
        ``levels``-deep reshape-sum pyramid stays aligned to the global
        grid (ops/pyramid.py)."""
        a = 1 << levels
        return (
            self.row0 % a == 0
            and self.col0 % a == 0
            and self.height % a == 0
            and self.width % a == 0
        )


def window_from_bounds(
    lat_range,
    lon_range,
    zoom: int,
    align_levels: int = 0,
    pad_multiple: int = 1,
) -> Window:
    """Smallest Window covering a lat/lon bounding box, grid-aligned.

    ``align_levels`` rounds the window out to 2^levels boundaries (for
    pyramid alignment); ``pad_multiple`` additionally pads height/width
    up to a multiple. Alignment is guaranteed (or a ValueError); the pad
    multiple is best-effort: it clamps to the grid size when the
    z``zoom`` grid is smaller than the requested multiple.
    """
    if align_levels > zoom:
        raise ValueError(
            f"align_levels={align_levels} exceeds zoom={zoom}: the grid has "
            f"only 2^{zoom} tiles per side, so 2^{align_levels}-alignment is "
            "impossible"
        )
    lat_lo, lat_hi = min(lat_range), max(lat_range)
    lon_lo, lon_hi = min(lon_range), max(lon_range)
    n = 1 << zoom
    # Rows grow southward: the high latitude gives the low row.
    r_lo = int(_tile._row_from_latitude(min(lat_hi, mercator.MAX_LATITUDE), zoom))
    r_hi = int(_tile._row_from_latitude(max(lat_lo, -mercator.MAX_LATITUDE), zoom))
    c_lo = int(_tile._column_from_longitude(lon_lo, zoom))
    c_hi = int(_tile._column_from_longitude(lon_hi, zoom))
    r_lo, c_lo = max(r_lo, 0), max(c_lo, 0)
    r_hi, c_hi = min(r_hi, n - 1), min(c_hi, n - 1)
    if r_hi < r_lo or c_hi < c_lo:
        raise ValueError(
            f"bounds lat={lat_range} lon={lon_range} cover no tiles at z{zoom}"
        )

    a = 1 << align_levels
    row0 = (r_lo // a) * a
    col0 = (c_lo // a) * a
    height = -((-(r_hi + 1 - row0)) // a) * a
    width = -((-(c_hi + 1 - col0)) // a) * a

    def _pad(extent, origin):
        # Quantum must satisfy BOTH constraints: lcm(pad_multiple, a).
        m = math.lcm(pad_multiple, a)
        padded = min(-((-extent) // m) * m, n)
        # Keep inside the global grid by sliding the origin back if needed.
        origin = min(origin, max(0, n - padded))
        return padded, origin

    height, row0 = _pad(height, row0)
    width, col0 = _pad(width, col0)
    win = Window(zoom=zoom, row0=row0, col0=col0, height=height, width=width)
    if align_levels and not win.aligned_to(align_levels):
        raise ValueError(
            f"could not align window to 2^{align_levels} boundaries within "
            f"the z{zoom} grid: {win}"
        )
    return win


#: Windows at or below this cell count go to the CUDA histogram kernel
#: under backend="auto" on a CUDA device (the JAX package's threshold
#: for its whole-window kernel); larger ones to the partitioned kernel.
PALLAS_AUTO_MAX_CELLS = 256 * 256


def _pick_backend(backend: str, window: Window, device) -> str:
    """The backend that ``backend`` resolves to for ``window`` on
    ``device``: an explicit name as given; "auto" gives "pallas" (the
    histogram kernel) for windows of at most PALLAS_AUTO_MAX_CELLS cells
    and "partitioned" above that on a CUDA device, and "xla" (the plain
    scatter) on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown binning backend {backend!r} (valid: "
            f"{', '.join(BACKENDS)})")
    if backend != "auto":
        return backend
    if torch.device(device).type != "cuda":
        return "xla"
    if window.height * window.width <= PALLAS_AUTO_MAX_CELLS:
        return "pallas"
    return "partitioned"


def localise(row, col, window: Window, valid=None):
    """``(r, c, ok)``: int32 window-local row and column of each point
    and the mask of points inside the window (and ``valid``)."""
    r = torch.as_tensor(row).to(torch.int32) - window.row0
    c = torch.as_tensor(col).to(torch.int32) - window.col0
    ok = (r >= 0) & (r < window.height) & (c >= 0) & (c < window.width)
    if valid is not None:
        ok = ok & torch.as_tensor(valid, device=ok.device).to(torch.bool)
    return r, c, ok


def _scatter_window(row, col, window: Window, weights=None, valid=None,
                    dtype=None):
    """The plain scatter-add of points into the (H, W) raster.

    torch's ``index_add_`` has no ``mode="drop"``: dropped lanes (out of
    window or invalid) go to a spare slot ``hw`` of an ``hw + 1`` buffer
    that is sliced off, so no out-of-range index reaches a scatter (on
    CUDA that would be a device assert, not a drop). A dropped lane's
    weight, NaN included, lands only in that spare slot.
    """
    if dtype is None:
        dtype = torch.int32 if weights is None else torch.float32
    r, c, ok = localise(row, col, window, valid)
    hw = window.height * window.width
    idx = torch.where(ok, r.to(torch.int64) * window.width + c, hw)
    if weights is None:
        w = torch.ones(idx.shape, dtype=dtype, device=idx.device)
    else:
        w = torch.as_tensor(weights, device=idx.device).to(dtype)
    flat = torch.zeros(hw + 1, dtype=dtype, device=idx.device)
    flat.index_add_(0, idx, w)
    return flat[:hw].reshape(window.height, window.width)


def _plain(row, col, window: Window, weights, valid):
    """The plain PyTorch version of both window kernels (histogram and
    partitioned): the scatter-add with a drop slot, int32 counts or
    float32 sums. A CPU tensor runs it; no CUDA path calls it."""
    return _scatter_window(row, col, window, weights=weights, valid=valid)


def bin_rowcol_window(row, col, window: Window, weights=None, valid=None,
                      dtype=None, backend: str = "xla"):
    """Add pre-projected (row, col) points into a window raster.

    Out-of-window and invalid points are dropped. Returns an (H, W)
    raster of ``dtype`` (int32 counts / float32 weighted sums by
    default). ``backend`` as in the module docstring; "auto" resolves
    on the points' device.
    """
    if dtype is None:
        dtype = torch.int32 if weights is None else torch.float32
    row = torch.as_tensor(row)
    picked = _pick_backend(backend, window, row.device)
    with stage_span("bin.window", items=row.numel(), backend=picked):
        if picked == "partitioned":
            from heatmap_tpu_torch.ops.partitioned import (
                bin_rowcol_window_partitioned,
            )

            raster = bin_rowcol_window_partitioned(
                row, col, window, weights=weights, valid=valid, dtype=dtype
            )
        elif picked == "pallas":
            from heatmap_tpu_torch.ops.pallas_kernels import (
                bin_rowcol_window_pallas,
            )

            raster = bin_rowcol_window_pallas(
                row, col, window, weights=weights, valid=valid
            ).to(dtype)
        else:
            raster = _scatter_window(row, col, window, weights=weights,
                                     valid=valid, dtype=dtype)
        return stage_block(raster)


def bin_points_window(
    latitude,
    longitude,
    window: Window,
    weights=None,
    valid=None,
    proj_dtype=torch.float64,
    dtype=None,
    backend: str = "xla",
):
    """Project lat/lon points and add them into a window raster.

    ``proj_dtype`` picks the projection precision (float64 exact,
    float32 fast; tilemath/mercator.py). ``valid`` ANDs with the
    projection validity mask. ``backend`` as in bin_rowcol_window.
    """
    row, col, proj_valid = mercator.project_points(
        latitude, longitude, window.zoom, dtype=proj_dtype
    )
    if valid is not None:
        proj_valid = proj_valid & torch.as_tensor(valid,
                                                  device=proj_valid.device)
    return bin_rowcol_window(
        row, col, window, weights=weights, valid=proj_valid, dtype=dtype,
        backend=backend,
    )
