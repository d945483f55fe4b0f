"""The reference batch job (``batchMain``) over one table of GPS rows.

Semantics of the reference ``heatmap.py:25-129``:

- rows whose ``source`` is ``background`` are dropped;
- every kept point counts once for the ``all`` group and once for its
  user's group, where ids starting ``x`` are left out of per-user
  heatmaps and ids starting ``rt-`` are pooled under ``route``;
- points are binned at the detail zoom and rolled up one zoom a level,
  for ``levels`` levels; a tile's parent is ``(row // 2, col // 2)``,
  which is where the reference's re-projection of the tile's centre
  lands, half a tile from every edge;
- each level's counts are grouped into blobs keyed
  ``user|timespan|coarse tile`` with the coarse tile ``result_delta``
  zooms up, and each blob is a JSON object ``{"z_row_col": count}``
  (counts as floats, ``json.dumps`` separators).

The guarantee held is that the blobs are byte-equal: the entries of a
blob stand in Z-order of their tiles, as the port and the JAX package
write them.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.tiles import rows_cols, z_order

ALL = "all"


def route(user_id: str):
    """The per-user group of an id, or None where it has none."""
    if user_id[:1] == "x":
        return None
    if user_id[:3] == "rt-":
        return "route"
    return user_id


def level_counts(table: dict, job: dict, precision: str = "float64"):
    """Per level, the sorted unique ``(group, z-order)`` keys and their
    counts: ``(names, [(zoom, keys, counts), ...])`` with ``names`` the
    group of each group index."""
    keep = np.asarray(table["source"], dtype=object) != "background"
    idx = np.flatnonzero(keep)
    lat = np.asarray(table["latitude"])[idx]
    lon = np.asarray(table["longitude"])[idx]
    users = np.asarray(table["user_id"], dtype=object)[idx]
    uniq, inv = np.unique(users.astype(str), return_inverse=True)
    routed = [route(u) for u in uniq]
    names = [ALL] + sorted({r for r in routed if r is not None} - {ALL})
    gid = {g: i for i, g in enumerate(names)}
    user_gid = np.array([-1 if r is None else gid[r] for r in routed],
                        np.int64)[inv]
    zoom = job["detail_zoom"]
    row, col, ok = rows_cols(lat, lon, zoom, precision)
    z0 = z_order(row[ok], col[ok])
    g = user_gid[ok]
    codes = np.concatenate([z0, z0[g >= 0]])
    groups = np.concatenate([np.zeros(len(z0), np.int64), g[g >= 0]])
    out = []
    for level in range(job["levels"]):
        z = zoom - level
        keys = (groups << (2 * z)) | (codes >> (2 * level))
        uk, cnt = np.unique(keys, return_counts=True)
        out.append((z, uk, cnt))
    return names, out


def _unspread(v):
    v = v & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


def _digits(v, width: int):
    """ASCII digits of non-negative ints below ``10^width``, right-aligned
    in ``width`` columns, with the mask of the columns they fill."""
    v = np.asarray(v, np.int64).astype(np.int32 if width < 10 else np.int64)
    chars = np.empty((len(v), width), np.uint8)
    mask = np.empty((len(v), width), bool)
    mask[:, -1] = True
    for j in range(width - 1, -1, -1):
        chars[:, j] = v % 10 + 48
        v = v // 10
        if j:
            mask[:, j - 1] = v > 0
    return chars, mask


def _text(s: str, n: int):
    chars = np.frombuffer(s.encode(), np.uint8)
    return (np.broadcast_to(chars, (n, len(chars))),
            np.ones((n, len(chars)), bool))


def _level_json(z: int, row, col, cnt, starts, ends):
    """The JSON document of each blob of one level, formatted in bulk:
    every entry ``"z_row_col": count.0`` as a row of bytes, a blob's
    entries joined by ``, `` inside ``{}``."""
    n = len(row)
    first = np.zeros(n, bool)
    first[starts] = True
    last = np.zeros(n, bool)
    last[ends - 1] = True
    sep = np.where(first[:, None], np.array([ord("{"), 0], np.uint8),
                   np.array([ord(","), ord(" ")], np.uint8))
    sep_mask = np.stack([np.ones(n, bool), ~first], axis=1)
    width = len(str(1 << z))
    parts = [
        (sep, sep_mask),
        _text(f'"{z}_', n),
        _digits(row, width),
        _text("_", n),
        _digits(col, width),
        _text('": ', n),
        _digits(cnt, max(1, len(str(int(cnt.max(initial=0)))))),
        _text(".0", n),
        (np.full((n, 1), ord("}"), np.uint8), last[:, None]),
    ]
    chars = np.concatenate([p[0] for p in parts], axis=1)
    mask = np.concatenate([p[1] for p in parts], axis=1)
    text = chars[mask].tobytes().decode("ascii")
    off = np.concatenate([[0], np.cumsum(mask.sum(axis=1))]).tolist()
    return [text[off[s]:off[e]] for s, e in zip(starts.tolist(),
                                                 ends.tolist())]


def blobs(names, levels, job: dict) -> dict:
    """``{blob_id: json}`` of every level."""
    delta = job["result_delta"]
    span = job["timespan"]
    out = {}
    for z, keys, cnt in levels:
        if len(keys) == 0:
            continue
        g = keys >> (2 * z)
        code = keys & ((1 << (2 * z)) - 1)
        row = _unspread(code >> 1)
        col = _unspread(code)
        blob = (g << (2 * z)) | (code >> (2 * delta))
        starts = np.flatnonzero(np.concatenate([[True], blob[1:] != blob[:-1]]))
        ends = np.append(starts[1:], len(keys))
        docs = _level_json(z, row, col, cnt, starts, ends)
        cz = z - delta
        ids = [f"{names[gi]}|{span}|{cz}_{r}_{c}" for gi, r, c in
               zip(g[starts].tolist(), (row[starts] >> delta).tolist(),
                   (col[starts] >> delta).tolist())]
        out.update(zip(ids, docs))
    return out


def job_blobs(table: dict, job: dict, precision: str = "float64") -> dict:
    names, levels = level_counts(table, job, precision)
    return blobs(names, levels, job)
