"""Top-B wavelet synopses of coarse pyramid levels.

The port's copy of heatmap_tpu/synopsis/build.py: for the same level
arrays it writes the same ``synopsis-z*.npz`` bytes.

``write_synopses`` turns every ``level_z*.npz`` below ``max_z`` in a
level directory into a ``synopsis-z{zoom:02d}.npz`` sitting alongside
it: per (user, timespan) pair, the top-B Haar coefficients of the
dense per-cell count grid by absolute value, plus the ACHIEVED L-inf
reconstruction error stamped into the artifact header.

Error contract (docs/synopsis.md): the stamped ``max_err`` is computed
at build time as ``max|inv_haar(kept) - grid|`` — not an analytic
upper bound but the exact worst cell error, measured after the same
f64 inverse transform the serving decoder runs. Decoding is
deterministic, so every decoded cell differs from the exact count by
<= the stamp, with equality somewhere. ``b=None`` picks
``default_b(nnz)`` per pair; ``b=math.inf`` keeps every nonzero
coefficient, which round-trips integer grids bit-exact (see
transform.py on why unnormalized Haar makes that true).

Artifact schema ``heatmap-tpu.synopsis.v1`` (compressed npz):
scalars ``zoom``/``coarse_zoom``/``n`` (grid side ``2**zoom``), per-pair
``users``/``timespans``/``b``/``max_err``/``offsets`` (CSR-style,
``n_pairs + 1``), and flat ``idx`` (int64 row-major coefficient index)
/ ``val`` (f64) slabs. Writes are atomic (tmp + os.replace) under the
``sink.write`` retry site, the same publish discipline as the exact
level files — a torn synopsis can only be a crash artifact, which the
delta recovery sweep quarantines (delta/recover.py).

Numpy-only: this module sits on the serve tier's decode path.
"""

from __future__ import annotations

import math
import os
import zipfile

import numpy as np

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.synopsis.transform import (grid_from_rows_np, haar2d_np,
                                            inv_haar2d_np)

__all__ = [
    "DEFAULT_MAX_Z", "HARD_MAX_Z", "SCHEMA", "default_b", "build_pair",
    "decode_pair", "write_synopses", "load_synopses", "synopsis_path",
    "verify_synopsis", "SynopsisPair",
]

SCHEMA = "heatmap-tpu.synopsis.v1"

#: Levels with zoom < DEFAULT_MAX_Z get a synopsis; finer levels stay
#: exact-only (their grids are big and their tiles are the leaf detail
#: users zoom into — bounded error is a coarse-overview trade).
DEFAULT_MAX_Z = 10

#: Refusal ceiling: a 2**HARD_MAX_Z square f64 grid is 128 MiB per
#: (user, timespan) pair — beyond this the dense transform is the
#: wrong tool and the caller gets a loud error, not an OOM.
HARD_MAX_Z = 12


def default_b(nnz: int) -> int:
    """Default coefficient budget for a pair with ``nnz`` occupied
    cells: an 8:1 cell-to-coefficient ratio, floored so tiny pairs
    keep enough structure to be useful."""
    return max(16, int(nnz) // 8)


class SynopsisPair:
    """One (user, timespan) slice of one level's synopsis."""

    __slots__ = ("user", "timespan", "zoom", "n", "b", "max_err", "idx",
                 "val")

    def __init__(self, user, timespan, zoom, n, b, max_err, idx, val):
        self.user = str(user)
        self.timespan = str(timespan)
        self.zoom = int(zoom)
        self.n = int(n)
        self.b = int(b)
        self.max_err = float(max_err)
        self.idx = np.asarray(idx, np.int64)
        self.val = np.asarray(val, np.float64)

    def decode(self, extra_rows=None) -> np.ndarray:
        """Dense ``(n, n)`` decoded count grid; ``extra_rows`` is an
        optional ``(rows, cols, values)`` triple scatter-added ON TOP
        of the decoded grid (delta overlays / provisional micro-batch
        counts). Extras are exact additions, so they never widen the
        stamped error bound."""
        grid = decode_pair(self.idx, self.val, self.n)
        if extra_rows is not None:
            rows, cols, values = extra_rows
            np.add.at(grid, (np.asarray(rows, np.int64),
                             np.asarray(cols, np.int64)),
                      np.asarray(values, np.float64))
        return grid


def build_pair(rows, cols, values, zoom: int, b=None):
    """Synopsis of one pair's level rows -> ``(idx, val, max_err)``.

    ``b=None`` -> :func:`default_b`; ``b=math.inf`` -> every nonzero
    coefficient (bit-exact round trip for integer grids)."""
    if zoom > HARD_MAX_Z:
        raise ValueError(
            f"synopsis grids stop at zoom {HARD_MAX_Z} "
            f"(2^{HARD_MAX_Z} side); got zoom {zoom}")
    n = 1 << int(zoom)
    grid = grid_from_rows_np(rows, cols, values, n)
    flat = haar2d_np(grid).ravel()
    nz = np.flatnonzero(flat)
    if b is None:
        b = default_b(len(rows))
    if math.isinf(b) or b >= len(nz):
        kept = np.sort(nz)
        return kept, flat[kept], _achieved_err(grid, kept, flat[kept], n)
    # Top-B by |coefficient|, ties broken by index: lexsort's last key
    # is primary, so (-|v|, idx) gives a deterministic artifact.
    order = np.lexsort((nz, -np.abs(flat[nz])))
    kept = np.sort(nz[order[:int(b)]])
    return kept, flat[kept], _achieved_err(grid, kept, flat[kept], n)


def _achieved_err(grid, idx, val, n) -> float:
    decoded = decode_pair(idx, val, n)
    return float(np.abs(decoded - grid).max()) if n else 0.0


def decode_pair(idx, val, n: int) -> np.ndarray:
    """Serving decoder: sparse coefficients -> dense count grid."""
    coeffs = np.zeros(n * n, np.float64)
    coeffs[np.asarray(idx, np.int64)] = np.asarray(val, np.float64)
    return inv_haar2d_np(coeffs.reshape(n, n))


def synopsis_path(level_dir: str, zoom: int) -> str:
    return os.path.join(level_dir, f"synopsis-z{int(zoom):02d}.npz")


def _pair_strings(cols):
    """user/timespan string columns from a loaded OR finalized level
    dict (LevelArraysSink.load materializes strings; the finalized
    egress/merge shape carries idx + name tables)."""
    if "user" in cols:
        return np.asarray(cols["user"], str), np.asarray(
            cols["timespan"], str)
    return (np.asarray(cols["user_names"], str)[cols["user_idx"]],
            np.asarray(cols["timespan_names"], str)[cols["timespan_idx"]])


def write_synopses(level_dir: str, levels=None, *, b=None,
                   max_z: int = DEFAULT_MAX_Z) -> dict:
    """Build + atomically publish synopsis artifacts for every level
    below ``max_z`` in ``level_dir``.

    ``levels`` (``{zoom: cols}``) skips re-reading the level files when
    the caller already holds them (the egress sink and compaction do).
    Returns ``{zoom: {"pairs": n, "bytes": n, "max_err": worst}}`` and
    emits one ``synopsis_built`` event per level.
    """
    from heatmap_tpu_torch.io.sinks import LevelArraysSink
    from heatmap_tpu_torch.synopsis import metrics

    if levels is None:
        levels = LevelArraysSink.load(level_dir)
    out: dict = {}
    for zoom in sorted(levels):
        if int(zoom) >= max_z:
            continue
        cols = levels[zoom]
        users, tss = _pair_strings(cols)
        rows = np.asarray(cols["row"], np.int64)
        cls = np.asarray(cols["col"], np.int64)
        vals = np.asarray(cols["value"], np.float64)
        pair_key = np.char.add(np.char.add(users, "|"), tss)
        p_users, p_tss, p_b, p_err = [], [], [], []
        offsets = [0]
        idx_parts, val_parts = [], []
        for pk in np.unique(pair_key):
            sel = pair_key == pk
            user, _, ts = str(pk).partition("|")
            idx, val, max_err = build_pair(rows[sel], cls[sel], vals[sel],
                                           int(zoom), b=b)
            p_users.append(user)
            p_tss.append(ts)
            p_b.append(len(idx))
            p_err.append(max_err)
            idx_parts.append(idx)
            val_parts.append(val)
            offsets.append(offsets[-1] + len(idx))
        final = synopsis_path(level_dir, int(zoom))
        payload = {
            "schema": np.asarray(SCHEMA),
            "zoom": np.asarray(int(zoom)),
            "coarse_zoom": np.asarray(int(cols["coarse_zoom"])),
            "n": np.asarray(1 << int(zoom)),
            "users": np.asarray(p_users, str),
            "timespans": np.asarray(p_tss, str),
            "b": np.asarray(p_b, np.int64),
            "max_err": np.asarray(p_err, np.float64),
            "offsets": np.asarray(offsets, np.int64),
            "idx": (np.concatenate(idx_parts) if idx_parts
                    else np.zeros(0, np.int64)),
            "val": (np.concatenate(val_parts) if val_parts
                    else np.zeros(0, np.float64)),
        }
        tmp = final + ".tmp"

        def _publish():
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **payload)
            os.replace(tmp, final)

        faults.retry_call(_publish, site="sink.write", key="synopsis")
        nbytes = os.path.getsize(final)
        worst = float(max(p_err)) if p_err else 0.0
        out[int(zoom)] = {"pairs": len(p_users), "bytes": nbytes,
                          "max_err": worst}
        if obs.metrics_enabled():
            metrics.SYNOPSIS_BYTES.inc(nbytes, level=str(int(zoom)))
            metrics.SYNOPSIS_MAX_ERROR.set(worst, level=str(int(zoom)))
        obs.emit("synopsis_built", zoom=int(zoom), pairs=len(p_users),
                 coefficients=int(offsets[-1]), bytes=nbytes,
                 max_err=worst, path=final)
    return out


def verify_synopsis(path: str) -> str | None:
    """None when ``path`` is a readable v1 synopsis artifact, else a
    fault description (the recovery sweep's quarantine detail)."""
    try:
        with np.load(path) as z:
            if str(z["schema"]) != SCHEMA:
                return f"schema {z['schema']!r} != {SCHEMA!r}"
            offsets = z["offsets"]
            if len(offsets) != len(z["users"]) + 1:
                return "offsets/users length mismatch"
            if len(z["idx"]) != int(offsets[-1]):
                return "idx shorter than offsets claim"
            len(z["val"]), len(z["b"]), len(z["max_err"])
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        return repr(e)
    return None


def load_synopses(level_dir: str) -> dict:
    """``{zoom: [SynopsisPair, ...]}`` for every readable synopsis
    artifact in ``level_dir``. Unreadable or wrong-schema files are
    SKIPPED, not raised — serving falls back to exact levels and the
    recovery sweep owns quarantining torn artifacts."""
    out: dict = {}
    try:
        names = sorted(os.listdir(level_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("synopsis-z") and name.endswith(".npz")):
            continue
        full = os.path.join(level_dir, name)
        try:
            with np.load(full) as z:
                if str(z["schema"]) != SCHEMA:
                    continue
                zoom = int(z["zoom"])
                n = int(z["n"])
                users = z["users"]
                tss = z["timespans"]
                bs = z["b"]
                errs = z["max_err"]
                offsets = z["offsets"]
                idx = z["idx"]
                val = z["val"]
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            continue
        pairs = []
        for i in range(len(users)):
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            pairs.append(SynopsisPair(users[i], tss[i], zoom, n,
                                      bs[i], errs[i], idx[lo:hi],
                                      val[lo:hi]))
        out[zoom] = pairs
    return out
