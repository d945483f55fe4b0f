"""Ingest sources: columnar point-batch readers.

Port of the synthetic, CSV, JSONL and Parquet readers of
heatmap_tpu/io/sources.py (HMPB files: io/hmpb.py).
Every source yields columnar batches (dicts of host numpy arrays and
string lists) with the reference's row contract (reference
heatmap.py:25-36): ``latitude``, ``longitude``, ``user_id``, ``source``,
``timestamp``, plus an optional ``value`` weight column. Rows with
``source == "background"`` are dropped by the loader
(pipeline.batch), not here.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Iterator

import numpy as np

from heatmap_tpu_torch import native

COLUMNS = ("latitude", "longitude", "user_id", "source", "timestamp")

#: Optional per-point weight column; file sources pass it through when
#: the input names one literally ``value``.
VALUE_COLUMN = "value"

DEFAULT_BATCH = 1 << 20


def _empty_batch():
    return {
        "latitude": np.empty(0, np.float64),
        "longitude": np.empty(0, np.float64),
        "user_id": [],
        "source": [],
        "timestamp": [],
    }


def _finalize_with_value(cols, vals):
    """Columns as a batch, plus the weight column when ``vals`` (per-row
    weights, missing entries already 1.0) is not None."""
    out = {
        "latitude": np.asarray(cols["latitude"], np.float64),
        "longitude": np.asarray(cols["longitude"], np.float64),
        "user_id": list(cols["user_id"]),
        "source": list(cols["source"]),
        "timestamp": list(cols["timestamp"]),
    }
    if vals is not None:
        out[VALUE_COLUMN] = np.asarray(vals, np.float64)
    return out


class Source:
    """Base: iterable of columnar batches."""

    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        raise NotImplementedError

    def close(self) -> None:
        """Release held resources. Base: no-op."""

    def rows(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        """Row-dict view (for pipeline.batch.load_rows and the
        reference's per-row mappers). Slow path; prefer ``batches``."""
        for b in self.batches(batch_size):
            lat, lon = b["latitude"], b["longitude"]
            for i in range(len(lat)):
                yield {
                    "latitude": float(lat[i]),
                    "longitude": float(lon[i]),
                    "user_id": b["user_id"][i],
                    "source": b["source"][i] if b["source"] else None,
                    "timestamp": b["timestamp"][i] if b["timestamp"] else None,
                }


@dataclasses.dataclass
class SyntheticSource(Source):
    """Clustered synthetic GPS traces (hot-spot mixture over a metro
    area) with a user-id pool exercising every reference routing rule
    (plain ids, ``x``-prefixed excluded ids, ``rt-`` route ids,
    ``background`` rows; reference heatmap.py:28-29,64-70).

    The point stream is the same as heatmap_tpu's SyntheticSource for
    the same ``(n, seed)``."""

    n: int
    seed: int = 0
    n_users: int = 32
    center: tuple = (47.6, -122.3)
    spread: tuple = (0.5, 0.7)
    hotspot_frac: float = 0.25
    background_frac: float = 0.05

    #: Internal generation chunk; the point stream is a pure function of
    #: (seed, chunk index), so any ``batch_size`` yields the same points.
    CHUNK = 1 << 16

    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        pending = _empty_batch()
        for chunk in self._chunks():
            for k in COLUMNS:
                if isinstance(pending[k], np.ndarray):
                    pending[k] = np.concatenate([pending[k], chunk[k]])
                else:
                    pending[k] = pending[k] + chunk[k]
            while len(pending["latitude"]) >= batch_size:
                yield {k: v[:batch_size] for k, v in pending.items()}
                pending = {k: v[batch_size:] for k, v in pending.items()}
        if len(pending["latitude"]):
            yield pending

    def _chunks(self) -> Iterator[dict]:
        users = self._user_pool()
        t0 = 1_500_000_000  # fixed epoch base for reproducibility
        emitted = 0
        chunk_idx = 0
        while emitted < self.n:
            m = min(self.n - emitted, self.CHUNK)
            rng = np.random.default_rng([self.seed, chunk_idx])
            hot = rng.random(m) < self.hotspot_frac
            lat = self.center[0] + rng.normal(0, self.spread[0], m)
            lon = self.center[1] + rng.normal(0, self.spread[1], m)
            lat[hot] = self.center[0] + rng.normal(0, 0.02, int(hot.sum()))
            lon[hot] = self.center[1] + rng.normal(0, 0.03, int(hot.sum()))
            uid = rng.integers(0, len(users), m)
            bg = rng.random(m) < self.background_frac
            yield {
                "latitude": lat,
                "longitude": lon,
                "user_id": [users[i] for i in uid],
                "source": np.where(bg, "background", "gps").tolist(),
                "timestamp": (t0 + rng.integers(0, 86400 * 365, m)).tolist(),
            }
            emitted += m
            chunk_idx += 1

    def _user_pool(self):
        users = [f"user-{i}" for i in range(self.n_users)]
        users += [f"x-{i}" for i in range(max(1, self.n_users // 8))]
        users += [f"rt-{i}" for i in range(max(1, self.n_users // 8))]
        return users


@dataclasses.dataclass
class CSVSource(Source):
    """CSV reader with a header row naming (a superset of) COLUMNS.

    Parses with the native C++ decoder (heatmap_tpu_torch.native) where
    the library loads and ``use_native`` is set, with Python's csv
    module otherwise; both yield the same batches.

    ``read_value=None`` (auto) reads a ``value`` weight column when the
    header names one, which routes off the native decoder (it knows the
    reference's columns only) onto the Python reader; ``False`` ignores
    the column and keeps the native route."""

    path: str
    use_native: bool = True
    read_value: bool | None = None

    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        has_value = (self.read_value is not False
                     and self.has_value_column())
        if self.use_native and not has_value and native.available():
            # Mid-stream errors propagate: falling back after yielding
            # would re-read rows and double-count.
            yield from native.parse_csv_batches(self.path, batch_size)
            return
        with open(self.path, newline="") as f:
            reader = csv.DictReader(f)
            cols = {k: [] for k in COLUMNS}
            vals = [] if has_value else None
            for row in reader:
                cols["latitude"].append(float(row["latitude"]))
                cols["longitude"].append(float(row["longitude"]))
                cols["user_id"].append(row.get("user_id", ""))
                cols["source"].append(row.get("source", ""))
                cols["timestamp"].append(row.get("timestamp"))
                if vals is not None:
                    v = row.get(VALUE_COLUMN)
                    vals.append(float(v) if v not in (None, "") else 1.0)
                if len(cols["latitude"]) >= batch_size:
                    yield _finalize_with_value(cols, vals)
                    cols = {k: [] for k in COLUMNS}
                    vals = [] if has_value else None
            if cols["latitude"]:
                yield _finalize_with_value(cols, vals)

    def has_value_column(self) -> bool:
        """Whether the CSV header names a ``value`` weight column."""
        with open(self.path, newline="") as f:
            header = next(csv.reader(f), None)
        return header is not None and VALUE_COLUMN in header


@dataclasses.dataclass
class JSONLSource(Source):
    """One JSON object per line with the reference column names.

    The FIRST data row decides whether the file is weighted
    (``read_value=None``): if it carries ``value``, every batch gets the
    column (missing entries default to 1.0); if it does not, a ``value``
    on a later row raises. ``read_value=True`` forces the weighted
    reading; ``False`` ignores the column."""

    path: str
    read_value: bool | None = None

    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        cols = {k: [] for k in COLUMNS}
        weighted = self.read_value  # None -> first data row decides
        vals = []
        line_no = 0
        with open(self.path) as f:
            for line in f:
                line_no += 1
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                v = row.get(VALUE_COLUMN)
                if weighted is None:
                    weighted = v is not None
                elif v is not None and not weighted and self.read_value is None:
                    raise ValueError(
                        f"{self.path}:{line_no}: 'value' appears after "
                        "the first row lacked it; weighted JSONL files "
                        "must carry the column from row 1 (missing "
                        "entries default to 1.0), or pass "
                        "read_value=True to force weighted reading"
                    )
                cols["latitude"].append(float(row["latitude"]))
                cols["longitude"].append(float(row["longitude"]))
                cols["user_id"].append(row.get("user_id", ""))
                cols["source"].append(row.get("source", ""))
                cols["timestamp"].append(row.get("timestamp"))
                if weighted:
                    vals.append(float(v) if v is not None else 1.0)
                if len(cols["latitude"]) >= batch_size:
                    yield _finalize_with_value(cols, vals if weighted else None)
                    cols = {k: [] for k in COLUMNS}
                    vals = []
        if cols["latitude"]:
            yield _finalize_with_value(cols, vals if weighted else None)


@dataclasses.dataclass
class ParquetSource(Source):
    """Parquet reader (pyarrow), batched at row-group granularity.

    A ``value`` weight column in the schema passes through (nulls
    default to 1.0) unless ``read_value=False``."""

    path: str
    read_value: bool | None = None

    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(self.path)
        for rb in pf.iter_batches(batch_size=batch_size):
            d = rb.to_pydict()
            out = {
                "latitude": np.asarray(d["latitude"], np.float64),
                "longitude": np.asarray(d["longitude"], np.float64),
                "user_id": [str(u) for u in d.get("user_id", [""] * rb.num_rows)],
                "source": [str(s) for s in d.get("source", [""] * rb.num_rows)],
                "timestamp": list(d.get("timestamp", [None] * rb.num_rows)),
            }
            if VALUE_COLUMN in d and self.read_value is not False:
                out[VALUE_COLUMN] = np.asarray(
                    [1.0 if v is None else float(v) for v in d[VALUE_COLUMN]],
                    np.float64,
                )
            yield out


def open_source(spec: str, read_value: bool | None = None):
    """Parse a source spec: ``synthetic:N[:seed]``, ``csv:PATH``,
    ``jsonl:PATH``, ``parquet:PATH``, ``hmpb:PATH`` (a file, or a
    directory of ``*.hmpb`` parts), or a bare ``.csv``/``.jsonl``/
    ``.ndjson``/``.parquet``/``.pq``/``.hmpb`` path.

    ``read_value`` controls the optional weight column of the CSV, JSONL
    and Parquet sources: None = read it when present, False = ignore
    it."""
    kind, _, rest = spec.partition(":")
    if kind == "hmpb" or (not rest and spec.endswith(".hmpb")):
        from heatmap_tpu_torch.io.hmpb import HMPBDirSource, HMPBSource

        path = rest or spec
        return HMPBDirSource(path) if os.path.isdir(path) else HMPBSource(path)
    if kind == "synthetic":
        parts = rest.split(":") if rest else ["1000000"]
        n = int(parts[0])
        seed = int(parts[1]) if len(parts) > 1 else 0
        return SyntheticSource(n=n, seed=seed)
    if kind == "csv":
        return CSVSource(rest, read_value=read_value)
    if kind == "jsonl":
        return JSONLSource(rest, read_value=read_value)
    if kind == "parquet":
        return ParquetSource(rest, read_value=read_value)
    if spec.endswith(".csv"):
        return CSVSource(spec, read_value=read_value)
    if spec.endswith((".jsonl", ".ndjson")):
        return JSONLSource(spec, read_value=read_value)
    if spec.endswith((".parquet", ".pq")):
        return ParquetSource(spec, read_value=read_value)
    raise ValueError(
        f"unrecognized source spec {spec!r} (synthetic:N[:seed], "
        "csv:PATH, jsonl:PATH, parquet:PATH or hmpb:PATH)"
    )
