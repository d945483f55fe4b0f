"""The one generator of the benchmark's inputs, driven by parameters.

Every input is a function of ``--seed``, a label and the parameters of
the cell's configuration and traffic files: point clouds on the device
(a frozen copy of the clustered mixture of ``heatmap_tpu_torch/bench.py``
``make_points``) and in-memory tables of GPS rows with user ids for
the batch job. Sizes never depend on the seed: a seed
moves points and shuffles rows, and every seed gives the same counts of
points, rows, users, background rows and excluded ids.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one input, from the run's seed (any whole number,
    negative or past 64 bits) and the input's label."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, label: str, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive_seed(seed, label))
    return gen


def mixture_points(n: int, dist: dict, seed: int, label: str, device,
                   dtype=torch.float64):
    """``(lat, lon)`` tensors of ``n`` points on ``device``.

    The mixture of ``bench.make_points``: the first ``n - n_hot`` points
    spread around ``dist["center"]`` with ``dist["spread"]`` degrees of
    standard deviation, then ``n_hot = int(n * dist["hot_share"])`` in a
    hot spot of ``dist["hot_spread"]`` around the same center. Drawn in
    a few large calls on the device.
    """
    gen = generator(seed, label, device)
    n_hot = int(n * dist["hot_share"])
    n_wide = n - n_hot
    (clat, clon) = dist["center"]
    cols = []
    for c, sd_wide, sd_hot in ((clat, dist["spread"][0], dist["hot_spread"][0]),
                               (clon, dist["spread"][1], dist["hot_spread"][1])):
        x = torch.empty(n, dtype=dtype, device=device)
        x[:n_wide].normal_(c, sd_wide, generator=gen)
        x[n_wide:].normal_(c, sd_hot, generator=gen)
        if "decimals" in dist:
            scale = 10.0 ** int(dist["decimals"])
            x.mul_(scale).round_().div_(scale)
        cols.append(x)
    return cols[0], cols[1]


def host_points(n: int, dist: dict, seed: int, label: str, device):
    """The same mixture as float64 numpy arrays on the host, made on
    ``device`` and copied back once."""
    lat, lon = mixture_points(n, dist, seed, label, device)
    return lat.cpu().numpy(), lon.cpu().numpy()


def user_ids(users: dict) -> list[str]:
    """The id of each user, by rank (rank 0 sends the most points).

    Every ``excluded_every``-th rank from ``excluded_offset`` gets an
    ``x-`` id, which the reference leaves out of per-user heatmaps, and
    every ``route_every``-th rank from ``route_offset`` an ``rt-`` id,
    which it pools under ``route``; the rest are plain ``user-`` ids.
    """
    ids = []
    for r in range(users["count"]):
        if r % users["excluded_every"] == users["excluded_offset"]:
            ids.append(f"x-{r:03d}")
        elif r % users["route_every"] == users["route_offset"]:
            ids.append(f"rt-{r:03d}")
        else:
            ids.append(f"user-{r:03d}")
    return ids


def points_per_user(kept: int, users: dict) -> np.ndarray:
    """Rows of each user among ``kept`` rows: Zipf shares
    ``rank^-zipf_exponent``, at least one row each, the rounding
    remainder to the top ranks. The same for every seed."""
    ranks = np.arange(1, users["count"] + 1, dtype=np.float64)
    w = ranks ** -float(users["zipf_exponent"])
    counts = np.maximum(np.floor(kept * w / w.sum()).astype(np.int64), 1)
    short = kept - int(counts.sum())
    i = 0
    while short != 0:
        step = 1 if short > 0 else -1
        if counts[i % len(counts)] + step >= 1:
            counts[i % len(counts)] += step
            short -= step
        i += 1
    return counts


def gps_table(n: int, cfg: dict, seed: int, label: str, device) -> dict:
    """One table of ``n`` GPS rows as the batch job's source holds it:
    float64 ``latitude`` and ``longitude``, ``user_id`` and ``source``
    string lists. Exactly ``round(n * background_share)`` rows are
    ``background``; the other rows' users follow :func:`points_per_user`;
    row order is a seeded shuffle."""
    lat, lon = host_points(n, cfg["points"], seed, label + ".points", device)
    rng = np.random.default_rng(derive_seed(seed, label + ".rows"))
    n_bg = int(round(n * cfg["background_share"]))
    ids = user_ids(cfg["users"])
    counts = points_per_user(n - n_bg, cfg["users"])
    owner = np.repeat(np.arange(len(ids)), counts)
    owner = np.concatenate([owner, rng.integers(0, len(ids), n_bg)])
    kind = np.concatenate([np.zeros(n - n_bg, bool), np.ones(n_bg, bool)])
    order = rng.permutation(n)
    names = np.asarray(ids, dtype=object)
    return {
        "latitude": lat,
        "longitude": lon,
        "user_id": names[owner[order]].tolist(),
        "source": np.where(kind[order], "background", "gps").tolist(),
    }


class TableSource:
    """A source held in host memory: the program's ``Source`` interface
    (``batches(batch_size)`` of columnar dicts) over one table."""

    def __init__(self, table: dict):
        self.table = table

    def __len__(self):
        return len(self.table["latitude"])

    def batches(self, batch_size: int = 1 << 20):
        t = self.table
        for a in range(0, len(self), batch_size):
            b = a + batch_size
            yield {k: v[a:b] for k, v in t.items()}
