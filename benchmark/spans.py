"""The program's own spans in a ``--trace 1`` run's device trace.

While the profiler records, each span of the program
(``heatmap_tpu_torch/utils/trace.py``) is a ``record_function`` range of
its name: a host event of :class:`benchmark.trace.Trace` on the kernels'
clock. A span's host time is the length of its intervals inside the
traced window; its device time is that of every kernel, copy and memset
whose launching CUDA runtime call (matched by ``correlation``) starts
inside one of its intervals. Intervals are matched by time alone, not by
thread: the spans that the cells read all open on the thread that runs
the unit, and no other thread launches work meanwhile.
"""

from __future__ import annotations

import numpy as np


def intervals(tr, name: str) -> list:
    """The union of the host intervals named ``name``, clipped to the
    traced window, as sorted ``[start, end]`` pairs (microseconds)."""
    ivs = sorted((max(a, tr.start), min(b, tr.end))
                 for a, b, n in tr.host if n == name)
    merged = []
    for a, b in ivs:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def host_ms(tr, name: str, units: int):
    """Host milliseconds per unit inside the span ``name``, or None where
    there is no trace or it holds no such span."""
    ivs = intervals(tr, name) if tr is not None else []
    if not ivs or not units:
        return None
    return sum(b - a for a, b in ivs) / 1e3 / units


def device_ms(tr, name: str, units: int):
    """Device milliseconds per unit of the work launched inside the span
    ``name``, or None where there is no trace, it holds no such span, or
    nothing ran on a device in it."""
    ivs = intervals(tr, name) if tr is not None else []
    if not ivs or not units or not tr.devices():
        return None
    starts = np.array([a for a, _ in ivs])
    ends = np.array([b for _, b in ivs])
    total = 0.0
    for ts, _, _, corr in tr._runtime:
        i = int(np.searchsorted(starts, ts, side="right")) - 1
        if i < 0 or ts > ends[i] or corr is None:
            continue
        total += sum(tr.device[k][1] - tr.device[k][0]
                     for k in tr._corr.get(corr, ()))
    return total / 1e3 / units
