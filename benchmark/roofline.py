"""Peaks of the card and the least bytes a kernel's call must move.

A copy of the arithmetic of ``chip_smoke.py`` (its window kernels' and
segment reduce's ``bytes_moved``), kept here so that the yardstick does
not move with the program, with one correction: a segment reduce is
counted as writing the unique keys and sums that its inputs give, not
its whole output ``capacity``.
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
