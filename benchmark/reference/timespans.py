"""The reference batch job with dated timespans over one table of GPS rows.

Semantics of the reference ``heatmap.py:25-129`` with every timespan of
its loop emitting (``heatmap.py:62-76`` without the early ``return``),
on top of :mod:`benchmark.reference.batch`:

- each kept point counts, for every requested timespan, once for the
  ``all`` group and once for its user's group (``x`` ids left out,
  ``rt-`` ids pooled under ``route``);
- a timespan's label is that of ``build_timespan_label``
  (``heatmap.py:38-52``) on the UTC date of the epoch-ms timestamp:
  ``alltime``, the year, ``YYYY-MM`` or ``YYYY-MM-DD``, zero-padded;
- blobs are keyed ``user|label|coarse tile``, their entries in Z-order,
  as in :func:`benchmark.reference.batch.blobs`.

Labels are formatted once per distinct day, from the day's ordinal
since 1970-01-01; ``utc_offset_h`` moves the day boundary (the control
that reads local time).
"""

from __future__ import annotations

import datetime

import numpy as np

from benchmark.reference import batch as ref_batch
from benchmark.reference.tiles import rows_cols, z_order

DAY_MS = 86_400_000
_EPOCH = datetime.date(1970, 1, 1)


def label(kind: str, date: datetime.date) -> str:
    """``build_timespan_label`` of ``heatmap.py:38-52``."""
    if kind == "alltime":
        return "alltime"
    if kind == "year":
        return str(date.year)
    if kind == "month":
        return f"{date.year}-{date.month:02d}"
    if kind == "day":
        return f"{date.year}-{date.month:02d}-{date.day:02d}"
    raise ValueError(f"unknown timespan {kind!r}")


def level_counts(table: dict, job: dict, precision: str = "float64",
                 utc_offset_h: int = 0):
    """Per level, the sorted unique ``(slot, z-order)`` keys and their
    counts: ``(slot_names, [(zoom, keys, counts), ...])`` with
    ``slot_names[slot]`` the blob id's ``user|label`` prefix."""
    keep = np.asarray(table["source"], dtype=object) != "background"
    idx = np.flatnonzero(keep)
    lat = np.asarray(table["latitude"])[idx]
    lon = np.asarray(table["longitude"])[idx]
    users = np.asarray(table["user_id"], dtype=object)[idx]
    stamps = np.asarray(table["timestamp"], np.int64)[idx]
    uniq, inv = np.unique(users.astype(str), return_inverse=True)
    routed = [ref_batch.route(u) for u in uniq]
    groups = [ref_batch.ALL] + sorted({r for r in routed if r is not None}
                                      - {ref_batch.ALL})
    gid = {g: i for i, g in enumerate(groups)}
    user_gid = np.array([-1 if r is None else gid[r] for r in routed],
                        np.int64)[inv]
    zoom = job["detail_zoom"]
    row, col, ok = rows_cols(lat, lon, zoom, precision)
    z0 = z_order(row[ok], col[ok])
    g = user_gid[ok]
    days = (stamps[ok] + utc_offset_h * 3_600_000) // DAY_MS
    udays, day_of = np.unique(days, return_inverse=True)
    dates = [_EPOCH + datetime.timedelta(days=int(d)) for d in udays]
    labels, label_id = [], {}
    per_kind = []
    for kind in job["timespans"]:
        ids = []
        for date in dates:
            text = label(kind, date)
            if text not in label_id:
                label_id[text] = len(labels)
                labels.append(text)
            ids.append(label_id[text])
        per_kind.append(np.asarray(ids, np.int64)[day_of])
    n_groups = len(groups)
    slot_names = [f"{gname}|{text}" for text in labels for gname in groups]
    user = g >= 0
    codes = np.concatenate([c for _ in per_kind for c in (z0, z0[user])])
    slots = np.concatenate([s for lid in per_kind for s in (
        lid * n_groups, lid[user] * n_groups + g[user])])
    out = []
    for level in range(job["levels"]):
        z = zoom - level
        keys = (slots << (2 * z)) | (codes >> (2 * level))
        uk, cnt = np.unique(keys, return_counts=True)
        out.append((z, uk, cnt))
    return slot_names, out


def blobs(slot_names, levels, job: dict) -> dict:
    """``{blob_id: json}`` of every level."""
    delta = job["result_delta"]
    out = {}
    for z, keys, cnt in levels:
        if len(keys) == 0:
            continue
        slot = keys >> (2 * z)
        code = keys & ((1 << (2 * z)) - 1)
        row = ref_batch._unspread(code >> 1)
        col = ref_batch._unspread(code)
        blob = (slot << (2 * z)) | (code >> (2 * delta))
        starts = np.flatnonzero(np.concatenate([[True], blob[1:] != blob[:-1]]))
        ends = np.append(starts[1:], len(keys))
        docs = ref_batch._level_json(z, row, col, cnt, starts, ends)
        cz = z - delta
        ids = [f"{slot_names[s]}|{cz}_{r}_{c}" for s, r, c in
               zip(slot[starts].tolist(), (row[starts] >> delta).tolist(),
                   (col[starts] >> delta).tolist())]
        out.update(zip(ids, docs))
    return out


def job_blobs(table: dict, job: dict, precision: str = "float64",
              utc_offset_h: int = 0) -> dict:
    names, levels = level_counts(table, job, precision, utc_offset_h)
    return blobs(names, levels, job)
