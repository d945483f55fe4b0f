"""Integral (summed-area) pyramids: O(1) range aggregates per level.

The port's copy of the numpy half of heatmap_tpu/analytics/integral.py:
for the same level arrays it writes the same ``integral-z*.npz`` bytes.
``integral2d_torch`` is the device twin of the JAX package's jit'd
scan ``integral2d_jax``; compaction builds integrals on the host in both
packages. The read side (``IntegralPair``, ``load_integrals``) serves
``/query``; ``merge_shard_sats`` sums per-shard tables.

``write_integrals`` turns every ``level_z*.npz`` below ``max_z`` in a
level directory into an ``integral-z{zoom:02d}.npz`` sitting alongside
it: per (user, timespan) pair, the 2D inclusive prefix sum
(summed-area table, the integral-histogram construction of arxiv
1711.01919) of the dense per-cell count grid, plus the matching
occupancy SAT (prefix counts of ``grid != 0``). Any axis-aligned
rectangle sum or occupied-cell count is then four corner lookups::

    sum(r0..r1, c0..c1) = S[r1,c1] - S[r0-1,c1] - S[r1,c0-1]
                          + S[r0-1,c0-1]

with the ``r0 == 0`` / ``c0 == 0`` terms dropped.

Exactness contract (docs/analytics.md): the SAT is exact in binary f64
for integer-valued grids — partial sums of integers stay below 2**53
and round-trip bit-exact — so ``/query?op=sum`` is pinned EQUAL to the brute-force sum over served
exact tiles, not approximately so. Float-weighted grids get the usual
f64 rounding instead of the pin.

Artifact schema ``heatmap-tpu.integral.v1`` (compressed npz): scalars
``zoom``/``coarse_zoom``/``n`` (grid side ``2**zoom``), per-pair
``users``/``timespans``, and stacked ``sat`` (f64, ``(pairs, n, n)``)
/ ``cnt`` (int64 occupancy SAT, same shape) slabs. Writes are atomic
(tmp + os.replace) under the ``sink.write`` retry site, the same
publish discipline as the exact level files — a torn integral can only
be a crash artifact, which the delta recovery sweep quarantines
(delta/recover.py, reason ``torn_integral``).

Numpy only.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.synopsis.transform import grid_from_rows_np

__all__ = [
    "DEFAULT_MAX_Z", "HARD_MAX_Z", "SCHEMA", "IntegralPair", "build_pair",
    "grid_from_sat", "integral2d_np", "integral2d_torch", "integral_path",
    "load_integrals", "merge_shard_sats", "verify_integral",
    "write_integrals",
]

SCHEMA = "heatmap-tpu.integral.v1"

#: Levels with zoom < DEFAULT_MAX_Z get an integral; finer levels stay
#: row-only (their grids are big and range queries over leaf detail
#: fall through to the exact rows — slower but still correct).
DEFAULT_MAX_Z = 10

#: Refusal ceiling: a 2**HARD_MAX_Z square f64 SAT is 128 MiB per
#: (user, timespan) pair — beyond this the dense scan is the wrong
#: tool and the caller gets a loud error, not an OOM. Matches the
#: synopsis subsystem's ceiling (synopsis/build.py).
HARD_MAX_Z = 12


def integral2d_np(grid: np.ndarray) -> np.ndarray:
    """2D inclusive prefix sum (summed-area table) of a 2D grid, f64."""
    grid = np.asarray(grid, np.float64)
    if grid.ndim != 2:
        raise ValueError(f"integral2d wants a 2D grid, got {grid.shape}")
    return np.cumsum(np.cumsum(grid, axis=0), axis=1)


def integral2d_torch(grid, device=None):
    """Device twin of :func:`integral2d_np`: two cumsums of a float64
    tensor on ``device`` (the grid's device when None). No kernel is
    warranted: O(n^2) adds with trivial arithmetic intensity."""
    import torch

    grid = torch.as_tensor(grid, device=device).to(torch.float64)
    if grid.ndim != 2:
        raise ValueError(
            f"integral2d wants a 2D grid, got {tuple(grid.shape)}")
    return torch.cumsum(torch.cumsum(grid, dim=0), dim=1)


def merge_shard_sats(parts) -> np.ndarray:
    """SAT of a Morton-sharded level from per-shard SATs. The prefix scan
    is linear: ``SAT(sum of shard grids) == sum(SAT(shard grid))``
    exactly, because each shard's grid is zero outside its Z-order
    range, so the elementwise sum is the whole merge."""
    parts = [np.asarray(p, np.float64) for p in parts]
    if not parts:
        raise ValueError("merge_shard_sats needs at least one shard SAT")
    out = parts[0].copy()
    for p in parts[1:]:
        if p.shape != out.shape:
            raise ValueError(
                f"shard SAT shapes differ: {p.shape} != {out.shape}")
        out += p
    return out


def grid_from_sat(sat: np.ndarray) -> np.ndarray:
    """Inverse of :func:`integral2d_np` by finite differences — exact
    in f64 for integer-valued grids (differences of exact integers)."""
    sat = np.asarray(sat, np.float64)
    return np.diff(np.diff(sat, axis=0, prepend=0.0), axis=1, prepend=0.0)


class IntegralPair:
    """One (user, timespan) slice of one level's integral pyramid."""

    __slots__ = ("user", "timespan", "zoom", "n", "sat", "cnt")

    def __init__(self, user, timespan, zoom, sat, cnt):
        self.user = str(user)
        self.timespan = str(timespan)
        self.zoom = int(zoom)
        self.sat = np.asarray(sat, np.float64)
        self.cnt = np.asarray(cnt, np.float64)
        self.n = int(self.sat.shape[0])

    @staticmethod
    def _rect(table, r0, c0, r1, c1) -> float:
        s = table[r1, c1]
        if r0:
            s -= table[r0 - 1, c1]
        if c0:
            s -= table[r1, c0 - 1]
        if r0 and c0:
            s += table[r0 - 1, c0 - 1]
        return float(s)

    def range_sum(self, r0, c0, r1, c1) -> float:
        """Sum over the inclusive cell rect — four corner lookups."""
        return self._rect(self.sat, r0, c0, r1, c1)

    def cell_count(self, r0, c0, r1, c1) -> int:
        """Occupied (nonzero) cells in the inclusive rect, O(1)."""
        return int(round(self._rect(self.cnt, r0, c0, r1, c1)))

    def grid(self) -> np.ndarray:
        """Dense ``(n, n)`` count grid recovered from the SAT."""
        return grid_from_sat(self.sat)

    def with_extras(self, rows, cols, values) -> "IntegralPair":
        """New pair with delta rows folded in: recover the grid,
        scatter-add the extras, rescan. Exact for integer grids, so a
        base integral plus live delta rows answers queries identically
        to a full recompute over base ⊕ deltas."""
        grid = self.grid()
        np.add.at(grid, (np.asarray(rows, np.int64),
                         np.asarray(cols, np.int64)),
                  np.asarray(values, np.float64))
        return IntegralPair(self.user, self.timespan, self.zoom,
                            integral2d_np(grid),
                            integral2d_np((grid != 0.0).astype(np.float64)))


def build_pair(rows, cols, values, zoom: int):
    """Integral of one pair's level rows -> ``(sat, cnt)`` SATs."""
    if zoom > HARD_MAX_Z:
        raise ValueError(
            f"integral grids stop at zoom {HARD_MAX_Z} "
            f"(2^{HARD_MAX_Z} side); got zoom {zoom}")
    n = 1 << int(zoom)
    grid = grid_from_rows_np(rows, cols, values, n)
    return (integral2d_np(grid),
            np.cumsum(np.cumsum((grid != 0.0).astype(np.int64), axis=0),
                      axis=1))


def integral_path(level_dir: str, zoom: int) -> str:
    return os.path.join(level_dir, f"integral-z{int(zoom):02d}.npz")


def _pair_strings(cols):
    """user/timespan string columns from a loaded OR finalized level
    dict (same dual shape as synopsis/build.py)."""
    if "user" in cols:
        return np.asarray(cols["user"], str), np.asarray(
            cols["timespan"], str)
    return (np.asarray(cols["user_names"], str)[cols["user_idx"]],
            np.asarray(cols["timespan_names"], str)[cols["timespan_idx"]])


def write_integrals(level_dir: str, levels=None, *,
                    max_z: int = DEFAULT_MAX_Z) -> dict:
    """Build + atomically publish integral artifacts for every level
    below ``max_z`` in ``level_dir``.

    ``levels`` (``{zoom: cols}``) skips re-reading the level files when
    the caller already holds them (the egress sink and compaction do).
    Returns ``{zoom: {"pairs": n, "bytes": n}}`` and emits one
    ``integral_built`` event per level.
    """
    from heatmap_tpu_torch.analytics import metrics
    from heatmap_tpu_torch.io.sinks import LevelArraysSink

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
        p_users, p_tss = [], []
        sat_parts, cnt_parts = [], []
        for pk in np.unique(pair_key):
            sel = pair_key == pk
            user, _, ts = str(pk).partition("|")
            sat, cnt = build_pair(rows[sel], cls[sel], vals[sel],
                                  int(zoom))
            p_users.append(user)
            p_tss.append(ts)
            sat_parts.append(sat)
            cnt_parts.append(cnt)
        n = 1 << int(zoom)
        final = integral_path(level_dir, int(zoom))
        payload = {
            "schema": np.asarray(SCHEMA),
            "zoom": np.asarray(int(zoom)),
            "coarse_zoom": np.asarray(int(cols["coarse_zoom"])),
            "n": np.asarray(n),
            "users": np.asarray(p_users, str),
            "timespans": np.asarray(p_tss, str),
            "sat": (np.stack(sat_parts) if sat_parts
                    else np.zeros((0, n, n), np.float64)),
            "cnt": (np.stack(cnt_parts).astype(np.int64) if cnt_parts
                    else np.zeros((0, n, n), np.int64)),
        }
        tmp = final + ".tmp"

        def _publish():
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **payload)
            os.replace(tmp, final)

        faults.retry_call(_publish, site="sink.write", key="integral")
        nbytes = os.path.getsize(final)
        out[int(zoom)] = {"pairs": len(p_users), "bytes": nbytes}
        if obs.metrics_enabled():
            metrics.INTEGRAL_BYTES.set(nbytes, level=str(int(zoom)))
        obs.emit("integral_built", zoom=int(zoom), pairs=len(p_users),
                 bytes=nbytes, path=final)
    return out


def verify_integral(path: str) -> str | None:
    """None when ``path`` is a readable v1 integral artifact, else a
    fault description (the recovery sweep's quarantine detail)."""
    try:
        with np.load(path) as z:
            if str(z["schema"]) != SCHEMA:
                return f"schema {z['schema']!r} != {SCHEMA!r}"
            n = int(z["n"])
            pairs = len(z["users"])
            if len(z["timespans"]) != pairs:
                return "users/timespans length mismatch"
            if z["sat"].shape != (pairs, n, n):
                return (f"sat shape {z['sat'].shape} != "
                        f"{(pairs, n, n)}")
            if z["cnt"].shape != (pairs, n, n):
                return (f"cnt shape {z['cnt'].shape} != "
                        f"{(pairs, n, n)}")
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        return repr(e)
    return None


def load_integrals(level_dir: str) -> dict:
    """``{zoom: [IntegralPair, ...]}`` for every readable integral
    artifact in ``level_dir``. Unreadable or wrong-schema files are
    SKIPPED, not raised — serving falls through to exact rows and the
    recovery sweep owns quarantining torn artifacts."""
    out: dict = {}
    try:
        names = sorted(os.listdir(level_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("integral-z") and name.endswith(".npz")):
            continue
        full = os.path.join(level_dir, name)
        try:
            with np.load(full) as z:
                if str(z["schema"]) != SCHEMA:
                    continue
                zoom = int(z["zoom"])
                users = z["users"]
                tss = z["timespans"]
                sat = z["sat"]
                cnt = z["cnt"]
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            continue
        pairs = []
        for i in range(len(users)):
            pairs.append(IntegralPair(users[i], tss[i], zoom,
                                      sat[i], cnt[i]))
        out[zoom] = pairs
    return out
