"""Peaks of the card and the least bytes a kernel's call must move.

A copy of the arithmetic of ``chip_smoke.py`` (the ``bytes_moved`` of its
window kernels, segment reduce, projection and dense pyramid), kept here
so that the yardstick does not move with the program, with one
correction: a segment reduce is counted as writing the unique keys and
sums that its inputs give, not its whole output ``capacity``.
"""

from __future__ import annotations

import pathlib

from benchmark.trace import global_functions

#: HBM bandwidth of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
#: 700 W power limit), bytes per second.
HBM_BYTES_PER_S = 3.35e12

CSRC = pathlib.Path(__file__).resolve().parent.parent / "heatmap_tpu_torch" / "csrc"


def window_bucketed_bytes(points: int, cells: int) -> int:
    """One counts call of the bucketed window kernel: each point's row
    and column (int32) and validity (1 byte) read once; the raster
    (4 bytes a cell) written once."""
    return points * (4 + 4 + 1) + 4 * cells


def segment_reduce_bytes(keys: int, unique: int) -> int:
    """One counts launch of the segment reduce over sorted int64 keys:
    the keys read once; each unique key (int64) and its count (int32)
    written once, and the unique count (int32)."""
    return 8 * keys + 12 * unique + 4


def project_mercator_bytes(points: int) -> int:
    """One float64 projection call: each point's latitude and longitude
    (float64) read once; its row and column (int32) and validity (1 byte)
    written once: 25 bytes a lane."""
    return points * (8 + 8 + 4 + 4 + 1)


def dense_pyramid_bytes(height: int, width: int, levels: int) -> int:
    """One dense pyramid of an int32 raster: the raster (4 bytes a cell)
    read once; each cell of levels 1 to ``levels``, every one half the
    height and width of the level below, written once."""
    coarser = sum((height >> i) * (width >> i) for i in range(1, levels + 1))
    return 4 * (height * width + coarser)


def share_pct(bytes_moved: float, device_s: float):
    """Least time over measured time, in percent, bound by HBM bandwidth;
    None where nothing was measured."""
    if device_s <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / device_s


def kernel_names(source: str) -> set:
    """The ``__global__`` functions of ``csrc/<source>.cu``: the kernels
    that one of the program's CUDA sources launches."""
    return global_functions((CSRC / f"{source}.cu").read_text())


def traced_share(ctx, source: str, counter: str, bytes_per_call: int):
    """Share of its roofline that ``csrc/<source>.cu`` reaches in a
    traced run that makes one call of it a unit: ``bytes_per_call`` a
    unit over the profiler's device time of its calls
    (``Trace.op_calls``). None where the calls seen are not one a unit,
    or their launches of the source's kernels are not the launches that
    the program counted in ``traced_counters[counter]``."""
    tr, c = ctx.trace, ctx.counters
    launches = c.get("traced_counters", {}).get(counter, 0)
    units = c.get("units", 0)
    if tr is None or not launches or not units:
        return None
    calls = tr.op_calls(kernel_names(source))
    if len(calls) != units or sum(k for _, k in calls) != launches:
        return None
    return share_pct(units * bytes_per_call, sum(s for s, _ in calls))
