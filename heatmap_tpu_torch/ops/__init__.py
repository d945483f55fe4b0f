"""Device operators of the port: the scatter segment reduce
(``sparse``), the CUDA segment-reduce kernel (``sparse_partitioned``),
the sparse and dense zoom pyramids (``pyramid``), window binning
(``histogram``) on its two CUDA kernels (``pallas_kernels``, the window
histogram, and ``partitioned``, the bucketed passes), and the Gaussian
splat (``splat``)."""

from heatmap_tpu_torch.ops.histogram import (
    Window,
    bin_points_window,
    bin_rowcol_window,
    window_from_bounds,
)
from heatmap_tpu_torch.ops.pyramid import (
    coarsen_raster,
    pyramid_from_raster,
    pyramid_sparse_morton,
)
from heatmap_tpu_torch.ops.sparse import aggregate_keys, aggregate_sorted_keys
from heatmap_tpu_torch.ops.splat import (
    bin_points_splat,
    gaussian_kernel_1d,
    splat_raster,
)

__all__ = [
    "Window", "aggregate_keys", "aggregate_sorted_keys", "bin_points_splat",
    "bin_points_window", "bin_rowcol_window", "coarsen_raster",
    "gaussian_kernel_1d", "pyramid_from_raster", "pyramid_sparse_morton",
    "splat_raster", "window_from_bounds",
]
