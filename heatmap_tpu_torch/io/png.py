"""Zero-dependency PNG tile rendering for heatmap rasters.

Copy of heatmap_tpu/io/png.py (numpy + zlib + struct, no imaging
dependency), so the port writes byte-identical tiles without importing
the JAX package. The colormap is applied vectorized on the host.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# A compact perceptual heat colormap (black->purple->orange->white),
# piecewise-linear control points in RGB.
_STOPS = np.array(
    [
        [0, 0, 0],
        [60, 0, 90],
        [140, 20, 60],
        [220, 90, 20],
        [255, 180, 40],
        [255, 255, 220],
    ],
    np.float64,
)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def png_bytes(img: np.ndarray) -> bytes:
    """Encode an image to PNG. ``img``: (H, W) u8 grayscale, (H, W, 3)
    RGB, or (H, W, 4) RGBA, dtype uint8."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError("png_bytes wants uint8")
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    elif img.ndim == 3 and img.shape[2] == 4:
        color_type = 6
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter byte 0 (None) prepended to each scanline.
    flat = img.reshape(h, -1)
    raw = np.empty((h, flat.shape[1] + 1), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = flat
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _chunk(b"IHDR", ihdr),
            _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
            _chunk(b"IEND", b""),
        ]
    )


def colorize(raster: np.ndarray, *, log_scale: bool = True,
             vmax: float | None = None, alpha: bool = True) -> np.ndarray:
    """Counts -> RGBA heat image (uint8). Zero-count cells are fully
    transparent when ``alpha``; intensity is log1p-scaled by default
    (heatmap counts are heavy-tailed)."""
    v = np.asarray(raster, np.float64)
    x = np.log1p(v) if log_scale else v
    top = float(np.log1p(vmax)) if (vmax is not None and log_scale) else (
        float(vmax) if vmax is not None else float(x.max()) or 1.0
    )
    t = np.clip(x / (top or 1.0), 0.0, 1.0)
    pos = t * (len(_STOPS) - 1)
    i0 = np.clip(pos.astype(np.int64), 0, len(_STOPS) - 2)
    frac = (pos - i0)[..., None]
    rgb = _STOPS[i0] * (1 - frac) + _STOPS[i0 + 1] * frac
    out = np.empty((*v.shape, 4), np.uint8)
    out[..., :3] = np.clip(rgb, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v > 0, 255, 0) if alpha else 255
    return out


def raster_to_png(raster, **kw) -> bytes:
    """Counts raster -> PNG bytes (RGBA heat tile)."""
    return png_bytes(colorize(np.asarray(raster), **kw))
