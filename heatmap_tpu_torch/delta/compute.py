"""Delta pyramid computation: only the new points through the cascade.

The port's copy of heatmap_tpu/delta/compute.py. No new kernels: a
delta artifact is the port's batch job (``pipeline.batch.run_job``,
auto-routing included, so a count batch on the card takes one
``torch.sort`` and the 16 launches of ``csrc/segment_reduce.cu``) run
over just the incremental batch, written in the columnar level format
(``io.sinks.LevelArraysSink``) that ``io/merge.py`` merges. Because
tile counts are pure sums, base ⊕ delta is exact.

Retractions ride the same path with the sign flipped at egress: the
retraction points cascade normally (positive counts, so the bounded
segment reduce stays valid) and the finalized level values are negated
before the sink writes them. By linearity that equals cascading
negative weights, without teaching the device path about signs.
"""

from __future__ import annotations

import collections.abc

import numpy as np

from heatmap_tpu_torch.io.sinks import LevelArraysSink

#: Rendered formats a cached tile can exist in (serve/http.py routes).
#: Kept local so importing the delta engine never drags the serve
#: package in; pinned equal to serve.live.TILE_FORMATS in tests.
TILE_FORMATS = ("png", "json")


class ColumnsSource:
    """In-memory point columns as a batch source.

    The ingest path already holds the whole batch in hand (it is
    hashed for the journal before anything runs), so the cascade can
    read it back without a round-trip through a file. Slicing works on
    both ndarray and list columns, matching io.sources batch layout.
    """

    COLUMNS = ("latitude", "longitude", "user_id", "source",
               "timestamp", "value")

    def __init__(self, cols: dict):
        self.cols = {k: cols[k] for k in self.COLUMNS if k in cols}
        if "latitude" not in self.cols or "user_id" not in self.cols:
            raise ValueError("point columns need latitude/longitude/user_id")
        n = len(self.cols["latitude"])
        for k, v in self.cols.items():
            if len(v) != n:
                raise ValueError(
                    f"column {k!r} has {len(v)} rows, expected {n}")
        self._n = n

    def __len__(self) -> int:
        return self._n

    def batches(self, batch_size: int = 1 << 20):
        for lo in range(0, self._n, batch_size):
            yield {k: v[lo:lo + batch_size] for k, v in self.cols.items()}


def read_columns(source, batch_size: int = 1 << 20) -> dict:
    """Drain a source into one concatenated column dict (the delta
    batch must be materialized anyway to content-hash it)."""
    lat, lon, value = [], [], []
    obj: dict = {"user_id": [], "source": [], "timestamp": []}
    seen: set = set()
    for b in source.batches(batch_size):
        lat.append(np.asarray(b["latitude"], np.float64))
        lon.append(np.asarray(b["longitude"], np.float64))
        for k in obj:
            if k in b:
                seen.add(k)
                obj[k].extend(list(b[k]))
        if "value" in b:
            seen.add("value")
            value.append(np.asarray(b["value"], np.float64))
    cols = {
        "latitude": np.concatenate(lat) if lat else np.zeros(0),
        "longitude": np.concatenate(lon) if lon else np.zeros(0),
        "user_id": obj["user_id"],
    }
    for k in ("source", "timestamp"):
        if k in seen:
            cols[k] = obj[k]
    if "value" in seen:
        cols["value"] = np.concatenate(value)
    return cols


class _NegatingLevels:
    """Sink adapter for retraction deltas: negate finalized level
    values on the way into the columnar sink (run_job routes to
    ``write_levels`` by presence, so this slots in transparently —
    including the spill path's per-level calls)."""

    def __init__(self, inner):
        self._inner = inner

    def write_levels(self, levels) -> int:
        return self._inner.write_levels([
            {**lvl, "value": np.negative(np.asarray(lvl["value"]))}
            for lvl in levels
        ])


def compute_delta(source, out_dir: str, config, *, sign: int = 1,
                  batch_size: int = 1 << 20, device="cuda", timer=None,
                  device_columns: dict | None = None):
    """Run ``source`` through the full batch cascade on ``device`` into a
    delta artifact dir (LevelArraysSink format). Returns run_job's
    stats. ``timer`` (a devices.StageTimer) records the job's fenced
    per-stage milliseconds; ``device_columns`` (fed tensors of the
    source's kept rows, see ``run_job``) replace its numeric host
    columns on the card."""
    from heatmap_tpu_torch.obs import tracing
    from heatmap_tpu_torch.pipeline.batch import run_job

    if sign not in (1, -1):
        raise ValueError("sign must be +1 (insert) or -1 (retraction)")
    sink = LevelArraysSink(out_dir)
    if sign == -1:
        sink = _NegatingLevels(sink)
    with tracing.span("delta.compute", sign=sign):
        return run_job(source, sink, config, batch_size=batch_size,
                       device=device, timer=timer,
                       device_columns=device_columns)


class TileKeySet(collections.abc.Set):
    """The set of cache keys ``(layer, zoom, x, y, format)`` a delta can
    change, held as the sorted distinct tiles of each (layer names,
    zoom) group, packed ``row << 32 | col``.

    It equals, element for element, the Python set the JAX package's
    ``affected_tile_keys`` builds, without building it: that set holds
    about 19 tuples per finest-level row (millions for one 262,144-point
    increment), while the count, membership and iteration here come
    from the arrays. ``set(keys)`` gives the JAX package's set.
    """

    def __init__(self, groups=()):
        #: (names, zoom, packed tiles); names the layer and its alias.
        self._groups = list(groups)
        self._len = sum(len(names) * len(codes)
                        for names, _z, codes in self._groups
                        ) * len(TILE_FORMATS)
        #: (name, zoom) -> packed tiles, for membership tests.
        self._index = {(nm, z): codes for names, z, codes in self._groups
                       for nm in names}

    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        for names, z, codes in self._groups:
            for code in codes.tolist():
                tr, tc = code >> 32, code & 0xFFFFFFFF
                for nm in names:
                    for fmt in TILE_FORMATS:
                        yield (nm, z, tc, tr, fmt)

    def __contains__(self, key) -> bool:
        try:
            nm, z, tc, tr, fmt = key
            code = (int(tr) << 32) | int(tc)
        except (TypeError, ValueError):
            return False
        if fmt not in TILE_FORMATS:
            return False
        try:
            codes = self._index.get((nm, z))
        except TypeError:  # an unhashable name or zoom
            return False
        if codes is None:
            return False
        i = int(np.searchsorted(codes, code))
        return i < len(codes) and int(codes[i]) == code

    @classmethod
    def _from_iterable(cls, it):
        # The result of a set operation with another kind of set: the
        # plain set of tuples the JAX package holds.
        return set(it)

    def __or__(self, other):
        """The union; two ``TileKeySet``s merge group by group (the
        write plane unions its ranges' keys, whose coarse tiles
        straddling a split appear in both; a range that deduplicated
        its sub-batch adds an empty set)."""
        if not other:
            return self
        if not isinstance(other, TileKeySet):
            return super().__or__(other)
        merged: dict = {}
        for names, z, codes in (*self._groups, *other._groups):
            prev = merged.get((names, z))
            merged[(names, z)] = (codes if prev is None
                                  else np.union1d(prev, codes))
        return TileKeySet((names, z, codes)
                          for (names, z), codes in merged.items())

    def __repr__(self) -> str:
        return f"TileKeySet({len(self)} keys)"


def affected_tile_keys(levels: dict,
                       alias: tuple = ("all|alltime", "default")):
    """Cache keys whose rendered bytes this delta can change, as a
    :class:`TileKeySet`.

    Mirrors serve/live.py ``LiveLayer.affected_keys``: every changed
    cell of the FINEST delta level (coarser delta cells are exactly
    its ancestors, by the cascade rollup), projected to every tile at
    request zooms 0..finest, per affected ``user|timespan`` layer
    (plus the ``default`` alias when the all|alltime pair changes),
    both formats. Requests finer than the stored detail zoom are not
    enumerated — the same bound live.py uses; give the cache a TTL if
    you serve those.

    ``levels`` is ``LevelArraysSink.load`` output: {zoom: columns with
    materialized string user/timespan}.
    """
    if not levels:
        return TileKeySet()
    finest = int(max(levels))
    cols = levels[finest]
    row = np.asarray(cols["row"], np.int64)
    col = np.asarray(cols["col"], np.int64)
    if not len(row):
        return TileKeySet()
    user = np.asarray(cols["user"]).astype(str)
    tspan = np.asarray(cols["timespan"]).astype(str)
    pair = np.char.add(np.char.add(user, "|"), tspan)
    pairs, inv = np.unique(pair, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(pairs) + 1))
    groups = []
    for i, name in enumerate(pairs.tolist()):
        names = (name, alias[1]) if name == alias[0] else (name,)
        sel = order[bounds[i]:bounds[i + 1]]
        r, c = row[sel], col[sel]
        for z in range(finest + 1):
            shift = finest - z
            groups.append((names, z,
                           np.unique(((r >> shift) << 32) | (c >> shift))))
    return TileKeySet(groups)
