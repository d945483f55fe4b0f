"""Tables of dated GPS trajectories for the dated batch job, from a seed.

A table holds ``points_per_job`` rows: the kept rows are one contiguous
fragment of each of the configuration's ``trajectories``, every
trajectory on one UTC day of the ``walk`` range, and the rest are
``background`` rows. Trajectories per user follow the users' Zipf shares
(:func:`benchmark.generate.points_per_user`, at least one each); the
kept rows are split evenly over the trajectories. A fragment starts at
a point of the configuration's mixture (:func:`benchmark.generate.
host_points`) and a uniform second of its day, then walks in steps of
``step_m`` metres, ``step_ms`` apart, with a heading that turns by a
normal ``turn_sd_rad`` a step. Sizes never depend on the seed.
"""

from __future__ import annotations

import datetime
import math

import numpy as np

from benchmark import generate

DAY_MS = 86_400_000
#: Degrees of latitude per metre on the mean Earth radius.
DEG_PER_M = 180.0 / (math.pi * 6_371_008.8)


def day_range(walk: dict) -> tuple[int, int]:
    """``(first day, number of days)`` of the walk's dates, as days since
    1970-01-01."""
    first = datetime.date.fromisoformat(walk["first_day"])
    last = datetime.date.fromisoformat(walk["last_day"])
    epoch = datetime.date(1970, 1, 1)
    return (first - epoch).days, (last - first).days + 1


def _within(values, starts, owner):
    """The running sum of ``values`` inside each fragment (``starts``: its
    first row; ``owner``: each row's fragment)."""
    total = np.cumsum(values)
    return total - (total[starts] - values[starts])[owner]


def dated_table(n: int, cfg: dict, seed: int, label: str, device) -> dict:
    """One table of ``n`` rows as the batch job's source holds it: float64
    ``latitude`` and ``longitude``, ``user_id`` and ``source`` string
    lists and int64 epoch-ms ``timestamp``; rows in a seeded shuffle."""
    walk = cfg["walk"]
    rng = np.random.default_rng(generate.derive_seed(seed, label + ".walk"))
    n_bg = int(round(n * cfg["background_share"]))
    kept = n - n_bg
    n_traj = min(int(cfg["trajectories"]), kept)
    ids = generate.user_ids(cfg["users"])
    traj_user = np.repeat(np.arange(len(ids)),
                          generate.points_per_user(n_traj, cfg["users"]))
    lengths = np.full(n_traj, kept // n_traj, np.int64)
    lengths[: kept % n_traj] += 1
    owner = np.repeat(np.arange(n_traj), lengths)
    starts = np.cumsum(lengths) - lengths

    first_day, n_days = day_range(walk)
    day = first_day + rng.integers(0, n_days, n_traj)
    t0 = day * DAY_MS + rng.integers(0, 86_400, n_traj) * 1000
    step = rng.uniform(walk["step_m"][0], walk["step_m"][1], kept)
    dt = rng.integers(walk["step_ms"][0], walk["step_ms"][1] + 1, kept)
    turn = rng.normal(0.0, walk["turn_sd_rad"], kept)
    step[starts] = 0.0
    dt[starts] = 0
    turn[starts] = 0.0
    heading = rng.uniform(0.0, 2 * math.pi, n_traj)[owner] + _within(
        turn, starts, owner)
    lat0, lon0 = generate.host_points(n_traj, cfg["points"], seed,
                                      label + ".starts", device)
    lat = lat0[owner] + _within(step * np.cos(heading), starts,
                                owner) * DEG_PER_M
    lon = lon0[owner] + _within(step * np.sin(heading), starts, owner) * (
        DEG_PER_M / np.cos(np.radians(lat0[owner])))
    stamp = t0[owner] + _within(dt, starts, owner)

    bg_lat, bg_lon = generate.host_points(n_bg, cfg["points"], seed,
                                          label + ".background", device)
    bg_stamp = (first_day * DAY_MS
                + rng.integers(0, n_days * DAY_MS, n_bg))
    user = np.concatenate([traj_user[owner], rng.integers(0, len(ids), n_bg)])
    kind = np.concatenate([np.zeros(kept, bool), np.ones(n_bg, bool)])
    order = rng.permutation(n)
    names = np.asarray(ids, dtype=object)
    return {
        "latitude": np.concatenate([lat, bg_lat])[order],
        "longitude": np.concatenate([lon, bg_lon])[order],
        "user_id": names[user[order]].tolist(),
        "source": np.where(kind[order], "background", "gps").tolist(),
        "timestamp": np.concatenate([stamp, bg_stamp])[order],
    }
