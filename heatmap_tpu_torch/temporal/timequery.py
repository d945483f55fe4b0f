"""Time-axis queries: Haar wavelet histograms over per-bucket series.

The port's copy of heatmap_tpu/temporal/timequery.py (numpy).

``op=topk_growth&window=1w`` asks "which cells grew the most this
window". The exact answer needs every cell's full per-bucket series;
this module compresses each series with the 1D Haar transform
(synopsis/transform.py — the same substrate as the spatial synopsis,
pointed at the epoch axis) and evaluates the growth functional on the
top-m coefficients only, with a sound error bound stamped on the
answer (arxiv 1110.6649's wavelet-histogram playbook, the temporal
twin of PR 14's integral-histogram /query engine).

Growth is LINEAR in the series: ``growth(x) = q . x`` where ``q`` is
-1 on the older half of the window's slots, +1 on the newer half, 0 on
padding. Writing the inverse transform as ``x = B c`` gives
``growth = (B^T q) . c = g . c`` — so per-coefficient contributions
``c_i * g_i`` are exact, the approximation keeps the m largest by
magnitude, and the dropped tail bounds the error by the triangle
inequality: ``|approx - exact| <= sum_dropped |c_i * g_i|``. Bucket
values are integer counts (or bounded-integer weighted sums) and ``g``
entries are powers of two over the padded length, so every product and
sum here is exact in f64 — the stamped bound is sound, which the
brute-force oracle test pins (tests/test_temporal.py).

Slots are the ordered end-edges of the selected units; a coarsened
(higher-tier) bucket occupies one slot at its own edge. ``bucket-none``
has no time axis and never contributes to growth.
"""

from __future__ import annotations

import os

import numpy as np

from heatmap_tpu_torch.delta.compact import read_current
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.synopsis.transform import haar1d_np, inv_haar1d_np
from heatmap_tpu_torch.temporal.fold import (
    Selection,
    TornBucketError,
    select_fold,
)

DEFAULT_COEFFS = 8


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _series_matrix(root: str, sel: Selection, *, user: str,
                   timespan: str, zoom: int):
    """-> (rows, cols, M) where M[i, j] is cell i's summed value in
    slot j (slots = sorted distinct unit end-edges), plus the slot
    edge list. Timed units only — bucket-none is timeless."""
    cur = read_current(root)
    base = cur.get("base")
    units = []
    for b in sel.buckets:
        d = os.path.join(root, base or "", "buckets", b["name"])
        units.append((d, float(b["t1"])))
    for u in sel.live:
        units.append((os.path.join(root, u["artifact"]), u["t1"]))
    edges = sorted({t1 for _, t1 in units})
    slot_of = {t1: j for j, t1 in enumerate(edges)}
    cells: dict = {}
    chunks = []  # (cell_idx array, slot, values)
    for d, t1 in units:
        if not os.path.isdir(d):
            raise TornBucketError(f"unit dir {d} missing (quarantined?)")
        try:
            loaded = LevelArraysSink.load(d)
        except Exception as e:
            raise TornBucketError(f"unreadable level dir {d}: {e!r}")
        lvl = loaded.get(int(zoom))
        if lvl is None:
            continue
        keep = ((np.asarray(lvl["user"], str) == user)
                & (np.asarray(lvl["timespan"], str) == timespan))
        if not keep.any():
            continue
        rr = np.asarray(lvl["row"])[keep]
        cc = np.asarray(lvl["col"])[keep]
        vv = np.asarray(lvl["value"], np.float64)[keep]
        idx = np.empty(len(rr), np.int64)
        for i, cell in enumerate(zip(rr.tolist(), cc.tolist())):
            idx[i] = cells.setdefault(cell, len(cells))
        chunks.append((idx, slot_of[t1], vv))
    m = np.zeros((len(cells), len(edges)), np.float64)
    for idx, j, vv in chunks:
        np.add.at(m[:, j], idx, vv)
    keys = np.empty((len(cells), 2), np.int64)
    for (r, c), i in cells.items():
        keys[i] = (r, c)
    return keys[:, 0], keys[:, 1], m, edges


def growth_series(m: np.ndarray, edges, ref: float, window: float,
                  coeffs: int):
    """Approximate growth per cell from the top-``coeffs`` wavelet
    contributions; -> (approx, bound, exact). ``exact`` is the full
    functional (cheap here, used for the stamped-bound invariant and
    the oracle test; a tiered deployment would keep only the retained
    coefficients per cell)."""
    nslots = m.shape[1]
    if nslots == 0:
        z = np.zeros(m.shape[0])
        return z, z.copy(), z.copy()
    pad = _next_pow2(nslots)
    mp = np.zeros((m.shape[0], pad), np.float64)
    mp[:, pad - nslots:] = m  # pad on the OLD side; recent slots last
    mid = float(ref) - float(window) / 2.0
    q = np.zeros(pad, np.float64)
    for j, t1 in enumerate(edges):
        q[pad - nslots + j] = 1.0 if t1 > mid else -1.0
    c = haar1d_np(mp)
    # g = B^T q: row i of inv_haar1d_np(I) is basis vector i, so the
    # matrix-vector product below is exactly (B^T q). pad is small
    # (window/width slots), so the dense identity transform is cheap.
    g = inv_haar1d_np(np.eye(pad)) @ q
    contrib = c * g[None, :]
    exact = contrib.sum(axis=1)
    k = min(int(coeffs), pad)
    order = np.argsort(np.abs(contrib), axis=1)  # ascending
    dropped = np.take_along_axis(contrib, order[:, :pad - k], axis=1)
    approx = exact - dropped.sum(axis=1)
    bound = np.abs(dropped).sum(axis=1)
    return approx, bound, exact


def topk_growth(root: str, *, user: str, timespan: str, zoom: int,
                window: float, k: int = 10,
                coeffs: int = DEFAULT_COEFFS) -> dict:
    """Top-k cells by approximate growth over the trailing window.

    One bounded-error scan: per-cell series from the window's buckets,
    1D Haar per cell, growth from the kept coefficients, achieved
    error bound stamped (``max_err`` = max bound among reported
    cells). Deterministic: ties break on (growth desc, row, col).
    """
    sel = select_fold(root, window=window)
    rows, cols, m, edges = _series_matrix(
        root, sel, user=user, timespan=timespan, zoom=int(zoom))
    approx, bound, _exact = growth_series(
        m, edges, sel.ref if sel.ref is not None else 0.0, window, coeffs)
    if len(approx):
        order = np.lexsort((cols, rows, -approx))[:int(k)]
    else:
        order = np.asarray([], np.int64)
    cells = [{"row": int(rows[i]), "col": int(cols[i]),
              "growth": float(approx[i]), "bound": float(bound[i])}
             for i in order]
    max_err = max((c["bound"] for c in cells), default=0.0)
    return {"op": "topk_growth", "zoom": int(zoom), "window": window,
            "slots": len(edges), "coeffs": int(coeffs), "cells": cells,
            "max_err": max_err, "token": sel.token}
