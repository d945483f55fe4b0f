"""Gaussian kernel splatting: weighted points -> smoothed heat rasters.

Port of heatmap_tpu/ops/splat.py. Points are added into a window raster
once (ops.histogram) and the raster is convolved with a separable
Gaussian, two ``torch.nn.functional.conv2d`` passes (the JAX package's
two ``lax.conv_general_dilated`` passes; no Pallas kernel is involved).
Convolution distributes over the sum of point masses, so this equals
stamping the kernel at every point.

cuDNN runs float32 convolutions in TF32 by default on Hopper, which
keeps 10 mantissa bits; :func:`splat_raster` turns TF32 off around its
convolutions so a float32 raster is smoothed in full float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from heatmap_tpu_torch.ops.histogram import Window, bin_points_window


def gaussian_kernel_1d(size: int = 9, sigma: float | None = None,
                       dtype=torch.float32):
    """Normalized 1D Gaussian taps. ``sigma`` defaults to size/4
    (sigma=2.25 for 9 taps), so the kernel truncates at ~2 sigma each
    side and renormalizes the clipped tail mass back in."""
    if size < 1 or size % 2 == 0:
        raise ValueError(f"kernel size must be odd and positive, got {size}")
    if sigma is None:
        sigma = size / 4.0
    if not sigma > 0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return torch.as_tensor(k).to(dtype)


def splat_raster(raster, kernel_1d):
    """Separable SAME convolution of an (H, W) raster with the outer
    product of ``kernel_1d`` with itself. Returns a float raster of the
    same shape: the raster's dtype if it is floating, else the kernel's."""
    k = torch.as_tensor(kernel_1d)
    x = torch.as_tensor(raster)
    out_dtype = x.dtype if x.is_floating_point() else k.dtype
    k = k.to(device=x.device, dtype=out_dtype)
    x = x.to(out_dtype)[None, None]  # NCHW
    kv = k[None, None, :, None]  # OIHW, vertical taps
    kh = k[None, None, None, :]  # horizontal taps
    half = (k.shape[0] - 1) // 2
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        x = F.conv2d(x, kv, padding=(half, 0))
        x = F.conv2d(x, kh, padding=(0, half))
    return x[0, 0]


def bin_points_splat(
    latitude,
    longitude,
    window: Window,
    weights=None,
    valid=None,
    kernel_size: int = 9,
    sigma: float | None = None,
    proj_dtype=torch.float64,
    dtype=None,
):
    """Project -> add into the window raster -> Gaussian splat.
    ``weights=None`` splats plain counts, accumulated exactly in int32
    and promoted to float by the convolution. Mass within
    ``kernel_size//2`` cells of the window edge bleeds out, as with any
    SAME-padded stamp."""
    raster = bin_points_window(
        latitude, longitude, window,
        weights=weights, valid=valid, proj_dtype=proj_dtype, dtype=dtype,
    )
    kernel_dtype = (raster.dtype if raster.is_floating_point()
                    else torch.float32)
    return splat_raster(raster,
                        gaussian_kernel_1d(kernel_size, sigma, kernel_dtype))
