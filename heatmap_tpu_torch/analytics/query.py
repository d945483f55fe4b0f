"""Numpy-only range-query evaluators over integral pyramids.

The port's copy of heatmap_tpu/analytics/query.py: the same answers for
the same levels and integrals.

Query semantics (docs/analytics.md): ``z`` names the SOURCE GRID zoom
— the level whose cells are being aggregated, grid side ``2**z`` — and
``bbox`` is an inclusive cell rectangle ``x0,y0,x1,y1`` (x = column,
y = row) with every coordinate in ``[0, 2**z)``. Grid zoom ``z``
corresponds to tile zoom ``z - result_delta``.

Three evaluators, each with an integral fast path and an exact
row-scan fall-through (used when a store predates integral artifacts):

- :func:`range_sum` — four corner lookups, O(1), pinned equal to the
  brute-force sum over served exact tiles.
- :func:`top_k_hotspots` — best-first coarse-to-fine descent over
  grid-aligned blocks, pruning every subtree whose range sum cannot
  reach the current k-th value. Exact for non-negative grids: a
  block's sum upper-bounds every contained cell.
- :func:`quantile` — binary search on cell-count thresholds over the
  same descent (``count_above(t)`` prunes blocks whose sum is <= t),
  finished exactly by stepping to the next occupied value.

``top_k_hotspots`` and ``quantile`` reserve their descents for rects
that are huge AND sparse; the common case sorts one vectorized dense
SAT-window reconstruction instead (see :data:`DESCENT_SPARSITY`).

All evaluators assume non-negative cell values — true for every store
this pipeline publishes (retraction stores prune to net counts and
drop non-positive cells before egress).
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from heatmap_tpu_torch.analytics.integral import IntegralPair
from heatmap_tpu_torch.tilemath.morton import morton_decode_np

__all__ = [
    "TEMPORAL_OPS", "VALID_OPS", "level_cells", "parse_bbox", "quantile",
    "quantile_rows", "range_sum",
    "range_sum_rows", "top_k_hotspots", "top_k_rows", "validate_op",
]

#: The spatial /query operations (serve/http.py 400s and CLI flags
#: validate against this single source of truth).
VALID_OPS = ("sum", "topk", "quantile")

#: Time-axis operations (heatmap_tpu_torch.temporal.timequery): listed
#: separately because they take a ``window`` instead of a ``bbox`` and
#: tools that sweep the spatial ops (tools/bench_query.py) must not
#: pick them up implicitly.
TEMPORAL_OPS = ("topk_growth",)


def validate_op(op: str) -> str:
    """``op`` unchanged, or a one-line ValueError naming the valid set."""
    if op not in VALID_OPS and op not in TEMPORAL_OPS:
        raise ValueError(
            f"unknown query op {op!r}: valid ops are "
            f"{', '.join(VALID_OPS + TEMPORAL_OPS)}")
    return op


def parse_bbox(text: str, zoom: int):
    """``"x0,y0,x1,y1"`` -> ``(r0, c0, r1, c1)`` inclusive cell rect.

    x = column, y = row, all in ``[0, 2**zoom)`` with ``x0 <= x1`` and
    ``y0 <= y1``; one-line ValueErrors (the /query 400 bodies)."""
    parts = str(text).split(",")
    if len(parts) != 4:
        raise ValueError(
            f"bbox must be 'x0,y0,x1,y1' (inclusive cells), got {text!r}")
    try:
        x0, y0, x1, y1 = (int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"bbox must be four integers 'x0,y0,x1,y1', got {text!r}")
    n = 1 << int(zoom)
    if not (0 <= x0 <= x1 < n and 0 <= y0 <= y1 < n):
        raise ValueError(
            f"bbox {text!r} out of range for zoom {zoom}: cells span "
            f"[0, {n}) and x0<=x1, y0<=y1")
    return y0, x0, y1, x1


# -- integral fast paths ---------------------------------------------------

#: ``top_k_hotspots`` and ``quantile`` run their Python block descents
#: only when the rect is HUGE and SPARSE — ``area > DESCENT_SPARSITY *
#: nnz`` — and otherwise sort one vectorized SAT-window reconstruction
#: (``_window_grid``). Measured crossover: a quantile bisection costs
#: ~1ms per occupied cell (64 passes x ~14 Python block visits each),
#: the dense window ~15ns per rect cell, so the descent only wins past
#: ~2**16 cells of area per occupied cell (e.g. a near-empty zoom-12
#: full-grid rect).
DESCENT_SPARSITY = 1 << 16


def _top_k_cells(rows, cols, vals, k: int):
    """Exact top-k over cell arrays with the (value desc, row asc,
    col asc) tie-break. ``np.partition`` first prunes to the tie
    closure of the k-th value so the lexsort only sees candidates —
    O(n + m log m) for m survivors instead of O(n log n)."""
    k = int(k)
    n = len(vals)
    if n > k:
        thresh = np.partition(vals, n - k)[n - k]
        keep = vals >= thresh
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = np.lexsort((cols, rows, -vals))[:k]
    return [(int(rows[i]), int(cols[i]), float(vals[i])) for i in order]


def range_sum(pair: IntegralPair, rect) -> float:
    """Exact rect sum in O(1): four SAT corner lookups."""
    return pair.range_sum(*rect)


def top_k_hotspots(pair: IntegralPair, rect, k: int, *,
                   sparsity: int = DESCENT_SPARSITY):
    """Top-``k`` hottest cells in the rect as ``(row, col, value)``.

    Best-first descent: a max-heap of grid-aligned blocks keyed by
    ``(-range_sum, r0, c0)``. A popped single cell outranks everything
    still queued (non-negative cells: a block's sum >= any contained
    cell), so cells emerge in exact descending order with the
    (value desc, row asc, col asc) tie-break — matching the exhaustive
    ``np.lexsort((cols, rows, -values))`` oracle. Zero-sum blocks are
    never queued, so only occupied cells are returned.

    The descent is output-sensitive on peaked grids but degenerates on
    FLAT ones (near-equal block sums defeat the pruning), so unless
    the rect is huge and sparse (``area > sparsity * nnz``, see
    :data:`DESCENT_SPARSITY`) a dense SAT-window reconstruction is
    sorted instead — same cells, same order."""
    r0, c0, r1, c1 = rect
    nnz = pair.cell_count(r0, c0, r1, c1)
    area = (r1 - r0 + 1) * (c1 - c0 + 1)
    if nnz and area <= sparsity * nnz:
        sub = _window_grid(pair, rect)
        rr, cc = np.nonzero(sub > 0.0)
        return _top_k_cells(rr.astype(np.int64) + r0,
                            cc.astype(np.int64) + c0, sub[rr, cc], k)
    out: list = []
    total = pair.range_sum(r0, c0, r1, c1)
    heap = [(-total, r0, c0, r1, c1)] if total > 0.0 else []
    while heap and len(out) < int(k):
        negs, br0, bc0, br1, bc1 = heapq.heappop(heap)
        if br0 == br1 and bc0 == bc1:
            out.append((br0, bc0, -negs))
            continue
        rm = (br0 + br1) // 2
        cm = (bc0 + bc1) // 2
        for qr0, qr1 in ((br0, rm), (rm + 1, br1)):
            if qr0 > qr1:
                continue
            for qc0, qc1 in ((bc0, cm), (cm + 1, bc1)):
                if qc0 > qc1:
                    continue
                s = pair.range_sum(qr0, qc0, qr1, qc1)
                if s > 0.0:
                    heapq.heappush(heap, (-s, qr0, qc0, qr1, qc1))
    return out


def _count_above(pair: IntegralPair, rect, t: float) -> int:
    """Cells in the rect with value strictly above ``t`` (``t >= 0``).

    Pruned descent: non-negative cells mean a block whose range sum is
    <= t cannot hold a cell above t, so whole subtrees drop out."""
    stack = [rect]
    count = 0
    while stack:
        br0, bc0, br1, bc1 = stack.pop()
        s = pair.range_sum(br0, bc0, br1, bc1)
        if s <= t:
            continue
        if br0 == br1 and bc0 == bc1:
            count += 1
            continue
        rm = (br0 + br1) // 2
        cm = (bc0 + bc1) // 2
        for qr0, qr1 in ((br0, rm), (rm + 1, br1)):
            if qr0 > qr1:
                continue
            for qc0, qc1 in ((bc0, cm), (cm + 1, bc1)):
                if qc0 > qc1:
                    continue
                stack.append((qr0, qc0, qr1, qc1))
    return count


def _min_above(pair: IntegralPair, rect, t: float):
    """Smallest cell value strictly above ``t`` in the rect, or None."""
    best = None
    stack = [rect]
    while stack:
        br0, bc0, br1, bc1 = stack.pop()
        s = pair.range_sum(br0, bc0, br1, bc1)
        if s <= t:
            continue
        if br0 == br1 and bc0 == bc1:
            if best is None or s < best:
                best = s
            continue
        rm = (br0 + br1) // 2
        cm = (bc0 + bc1) // 2
        for qr0, qr1 in ((br0, rm), (rm + 1, br1)):
            if qr0 > qr1:
                continue
            for qc0, qc1 in ((bc0, cm), (cm + 1, bc1)):
                if qc0 > qc1:
                    continue
                stack.append((qr0, qc0, qr1, qc1))
    return best


def _window_grid(pair: IntegralPair, rect) -> np.ndarray:
    """The rect's dense cell grid, recovered from the SAT: slice the
    window, double-difference it (exact in f64 for integer grids, the
    :func:`~heatmap_tpu_torch.analytics.grid_from_sat` identity). One
    vectorized O(area) pass — the fast path when the rect holds many
    occupied cells and per-cell descent would dominate."""
    r0, c0, r1, c1 = rect
    sat = pair.sat
    win = np.zeros((r1 - r0 + 2, c1 - c0 + 2), np.float64)
    win[1:, 1:] = sat[r0:r1 + 1, c0:c1 + 1]
    if r0:
        win[0, 1:] = sat[r0 - 1, c0:c1 + 1]
    if c0:
        win[1:, 0] = sat[r0:r1 + 1, c0 - 1]
        if r0:
            win[0, 0] = sat[r0 - 1, c0 - 1]
    return np.diff(np.diff(win, axis=0), axis=1)


def _window_values(pair: IntegralPair, rect) -> np.ndarray:
    """Occupied cell values of the rect's dense window."""
    sub = _window_grid(pair, rect)
    return sub[sub > 0.0]


def quantile(pair: IntegralPair, rect, q: float, *,
             sparsity: int = DESCENT_SPARSITY):
    """q-quantile over the rect's OCCUPIED cells, or None when empty.

    Defined as the ``ceil(q * nnz)``-th smallest occupied value
    (1-based; q=0 -> min, q=1 -> max) — equivalently the smallest
    occupied value with at most ``nnz - ceil(q*nnz)`` cells strictly
    above it. The common path sorts one vectorized SAT-window
    reconstruction of the rect. When the rect is huge and sparse
    (``area > sparsity * nnz``, see :data:`DESCENT_SPARSITY`) the
    O(area) window would dwarf the occupied set, so it instead runs a
    binary search on value thresholds driven by the pruned
    ``count_above`` descent, finished EXACTLY by stepping ``lo`` to
    the next occupied value until the count condition holds. Both
    paths equal the sorted-values oracle."""
    q = float(q)
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q!r}")
    r0, c0, r1, c1 = rect
    nnz = pair.cell_count(r0, c0, r1, c1)
    if nnz == 0:
        return None
    idx = max(0, math.ceil(q * nnz) - 1)  # 0-based order statistic
    area = (r1 - r0 + 1) * (c1 - c0 + 1)
    if area <= sparsity * nnz:
        return float(np.sort(_window_values(pair, rect))[idx])
    allowed = nnz - 1 - idx               # cells allowed strictly above
    # Invariants: count_above(lo) > allowed, count_above(hi) <= allowed
    # (every occupied value is positive and <= the rect's total sum).
    lo = 0.0
    hi = pair.range_sum(r0, c0, r1, c1)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if _count_above(pair, rect, mid) <= allowed:
            hi = mid
        else:
            lo = mid
    while True:
        s = _min_above(pair, rect, lo)  # exists: count_above(lo) > 0
        if _count_above(pair, rect, s) <= allowed:
            return float(s)
        lo = s


# -- exact row-scan fall-throughs ------------------------------------------


def level_cells(level, rect):
    """(rows, cols, values) of the level's stored cells inside the
    rect, positives only — stored levels never carry non-positive
    cells (delta stores prune them at merge), and the integral paths
    above never emit them, so both paths agree on "occupied"."""
    r0, c0, r1, c1 = rect
    rows, cols = morton_decode_np(level.codes)
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    m = ((rows >= r0) & (rows <= r1) & (cols >= c0) & (cols <= c1)
         & (level.values > 0.0))
    return rows[m], cols[m], level.values[m]


def range_sum_rows(level, rect) -> float:
    """Fall-through rect sum from the exact level rows — O(rows)."""
    _, _, vals = level_cells(level, rect)
    return float(vals.sum()) if len(vals) else 0.0


def top_k_rows(level, rect, k: int):
    """Fall-through top-k over the rect's cells with the same
    (value desc, row asc, col asc) tie-break."""
    rows, cols, vals = level_cells(level, rect)
    return _top_k_cells(rows, cols, vals, k)


def quantile_rows(level, rect, q: float):
    """Fall-through quantile: sort the rect's occupied values."""
    q = float(q)
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q!r}")
    _, _, vals = level_cells(level, rect)
    if not len(vals):
        return None
    vals = np.sort(vals)
    return float(vals[max(0, math.ceil(q * len(vals)) - 1)])
