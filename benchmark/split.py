"""One window step stage by stage, timed by CUDA events.

A copy of ``heatmap_tpu_torch/bench.py`` ``split_step`` that also hands
back the step's pyramid, so the benchmark's check can judge it: the
projection, the window binning, the dense pyramid and the top-level sum
with its host sync, each between two CUDA events.
"""

from __future__ import annotations

import torch

STAGES = ("project", "bin", "pyramid", "sum_sync")


def split_step(lat, lon, window, levels: int, backend: str, proj_dtype):
    """``({stage: ms}, pyramid)`` of one step on a CUDA device."""
    from heatmap_tpu_torch.bench import pyramid_capped
    from heatmap_tpu_torch.ops.histogram import bin_rowcol_window
    from heatmap_tpu_torch.tilemath import mercator

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
    return ({k: a.elapsed_time(b) for k, a, b in zip(STAGES, marks, marks[1:])},
            pyr)
