"""Headline benchmark of the port: points/s binned into a z0-z15 tile pyramid.

    python -m heatmap_tpu_torch.bench [--device cuda|cpu] [--n N] ...

The twin of the repo's ``bench.py``: the same clustered synthetic
points (2^25 by default, float32), the same z15 window
(``window_from_bounds((44, 51), (-127, -117), 15, align_levels=12,
pad_multiple=256)``, 4096 x 4096 cells), the same step (float32
projection, window binning, 2x2-sum pyramid up to z0) and the same
single-core numpy baseline. It runs on the device it is given, with no
probe and no fallback, and prints ONE JSON line of what actually ran:
points/s, ``vs_baseline``, the device's name, the requested and the
resolved binning backend, the kernel launches per step and, on a CUDA
device, the step split into its stages (``split_ms``: one more step
after the timed ones, fenced by CUDA events; the timed steps are not
fenced).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import numpy as np
import torch

from heatmap_tpu_torch.devices import resolve_device
from heatmap_tpu_torch.ops import partitioned, pallas_kernels
from heatmap_tpu_torch.ops.histogram import (
    BACKENDS,
    _pick_backend,
    bin_points_window,
    bin_rowcol_window,
    window_from_bounds,
)
from heatmap_tpu_torch.ops.pyramid import pyramid_from_raster
from heatmap_tpu_torch.tilemath import mercator
from heatmap_tpu_torch.utils.trace import stage_block, stage_span


def make_points(n, seed=0):
    """Clustered synthetic GPS points (hot-spot mixture over a metro
    area), float32; the same points as bench.py's ``_make_points``."""
    rng = np.random.default_rng(seed)
    n_hot = n // 4
    base_lat, base_lon = 47.6, -122.3
    lat = np.concatenate(
        [
            base_lat + rng.normal(0, 0.5, n - n_hot),
            base_lat + rng.normal(0, 0.02, n_hot),
        ]
    )
    lon = np.concatenate(
        [
            base_lon + rng.normal(0, 0.7, n - n_hot),
            base_lon + rng.normal(0, 0.03, n_hot),
        ]
    )
    return lat.astype(np.float32), lon.astype(np.float32)


def numpy_baseline(lat64, lon64, window, levels):
    """Single-core vectorized numpy version of the same step (bench.py's
    ``_numpy_baseline``); returns the binned point count."""
    n = 1 << window.zoom
    phi = lat64 * math.pi / 180
    y = (1 - np.log(np.tan(phi) + 1 / np.cos(phi)) / math.pi) / 2
    row = np.floor(y * n).astype(np.int64) - window.row0
    col = np.floor((lon64 + 180.0) / 360.0 * n).astype(np.int64) - window.col0
    ok = (row >= 0) & (row < window.height) & (col >= 0) & (col < window.width)
    raster = np.zeros((window.height, window.width), np.int32)
    np.add.at(raster, (row[ok], col[ok]), 1)
    out = raster
    for _ in range(levels):
        h, w = out.shape
        if h < 2 or w < 2:
            break
        out = out.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
    return raster.sum()


def headline_window(zoom: int = 15):
    return window_from_bounds(
        (44.0, 51.0), (-127.0, -117.0), zoom=zoom,
        align_levels=min(12, zoom), pad_multiple=256,
    )


def pyramid_capped(raster, levels: int):
    """[raster, coarsened once, ...]: up to ``levels`` 2x2 sums, stopping
    where a side would drop below 2 (bench.py's rollup), all from one
    :func:`pyramid_from_raster`."""
    h, w = raster.shape[-2:]
    n = 0
    while n < levels and min(h >> n, w >> n) >= 2:
        n += 1
    with stage_span("pyramid.coarsen", items=raster.numel()):
        out = pyramid_from_raster(raster, n)
        stage_block(None)
    return out


def step(lat, lon, window, levels: int, backend: str,
         proj_dtype=torch.float32):
    """One headline step: ``(top-level sum, pyramid)``."""
    raster = bin_points_window(lat, lon, window, proj_dtype=proj_dtype,
                               backend=backend)
    pyr = pyramid_capped(raster, levels)
    return pyr[-1].sum(), pyr


def split_step(lat, lon, window, levels: int, backend: str,
               proj_dtype=torch.float32) -> dict:
    """ms of one step's stages on a CUDA device, from CUDA events
    recorded between them: the projection, the binning, the pyramid, and
    the top-level sum with its host sync. The same work as :func:`step`,
    written out stage by stage."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    marks[0].record()
    row, col, valid = mercator.project_points(lat, lon, window.zoom,
                                              dtype=proj_dtype)
    marks[1].record()
    raster = bin_rowcol_window(row, col, window, valid=valid,
                               backend=backend)
    marks[2].record()
    pyr = pyramid_capped(raster, levels)
    marks[3].record()
    int(pyr[-1].sum())
    marks[4].record()
    torch.cuda.synchronize()
    names = ("project", "bin", "pyramid", "sum_sync")
    return {k: a.elapsed_time(b) for k, a, b in zip(names, marks, marks[1:])}


def _launches() -> int:
    return (pallas_kernels.bin_rowcol_window_pallas.launches
            + partitioned.bin_rowcol_window_partitioned.launches
            + partitioned.bin_rowcol_window_partitioned.weighted_launches)


def run(n: int = 1 << 25, zoom: int = 15, steps: int = 5,
        baseline_n: int = 1 << 20, backend: str = "auto",
        device="cuda") -> dict:
    """Time ``steps`` headline steps on ``device`` (median step) and the
    numpy baseline; returns the benchmark's JSON record."""
    dev = resolve_device(device)
    levels = zoom  # roll all the way to z0 (the window reaches 1x1 early)
    window = headline_window(zoom)
    lat, lon = make_points(n)
    d_lat = torch.as_tensor(lat, device=dev)
    d_lon = torch.as_tensor(lon, device=dev)
    resolved = _pick_backend(backend, window, dev)

    # Warm-up (builds the kernel on first use). int() of the total waits
    # for the device, so every timed step ends with its work done.
    total, _ = step(d_lat, d_lon, window, levels, backend)
    int(total)
    launches0 = _launches()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        total, _ = step(d_lat, d_lon, window, levels, backend)
        int(total)
        times.append(time.perf_counter() - t0)
    launches = _launches() - launches0
    dt = statistics.median(times)
    split = (split_step(d_lat, d_lon, window, levels, backend)
             if dev.type == "cuda" else None)

    bl_lat, bl_lon = make_points(baseline_n, seed=1)
    t0 = time.perf_counter()
    numpy_baseline(bl_lat.astype(np.float64), bl_lon.astype(np.float64),
                   window, levels)
    bl_dt = time.perf_counter() - t0
    pts_per_sec = n / dt
    return {
        "metric": f"points/sec binned into z0-z{zoom} tile pyramid",
        "value": pts_per_sec,
        "unit": "points/sec",
        "vs_baseline": pts_per_sec / (baseline_n / bl_dt),
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "points": n,
        "window": [window.height, window.width],
        "bin_backend": backend,
        "bin_backend_resolved": resolved,
        "launches_per_step": launches / steps,
        "step_ms": dt * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "split_ms": split,
        "baseline_points_per_s": baseline_n / bl_dt,
        "total": int(total),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m heatmap_tpu_torch.bench")
    ap.add_argument("--n", type=int, default=1 << 25, help="points per step")
    ap.add_argument("--zoom", type=int, default=15)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--baseline-n", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bin-backend", default="auto", choices=BACKENDS,
                    help="binning path: auto (by device and window size), "
                    "xla (the plain scatter), pallas (the histogram "
                    "kernel) or partitioned (the bucketed kernels)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.zoom, args.steps, args.baseline_n,
                         args.bin_backend, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
