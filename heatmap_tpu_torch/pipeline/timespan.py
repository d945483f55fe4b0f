"""Timespan labels: alltime / year / month / day buckets.

A copy of heatmap_tpu/pipeline/timespan.py for the PyTorch port.

The reference formats these in ``build_timespan_label`` (reference
heatmap.py:38-52) but the call site is commented out and an early
``return`` inside the timespan loop means only the first timespan could
ever emit (reference heatmap.py:62-76, SURVEY.md §8.2/§8.3 quirks).
Here the feature is implemented *correctly* — every requested timespan
emits — with labels matching the reference's formatting exactly;
"alltime"-only remains the default for output parity.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

ALLTIME = "alltime"
VALID_TYPES = ("alltime", "year", "month", "day")

#: Canonical missing-timestamp sentinel for integer epoch-ms columns
#: (the same value as heatmap_tpu's, whose HMPB format stores it).
TS_MISSING = np.iinfo(np.int64).min


def timespan_label(timespan_type: str, local_date) -> str:
    """Label for one timespan bucket; formatting per reference
    heatmap.py:38-52 (zero-padded month/day)."""
    if timespan_type == "alltime":
        return ALLTIME
    if timespan_type == "year":
        return str(local_date.year)
    if timespan_type == "month":
        return f"{local_date.year}-{local_date.month:02d}"
    if timespan_type == "day":
        return f"{local_date.year}-{local_date.month:02d}-{local_date.day:02d}"
    raise ValueError(f"unknown timespan type {timespan_type!r}; use {VALID_TYPES}")


def _to_date(ts):
    if ts is None:
        raise ValueError(
            "dated timespans (year/month/day) need a timestamp column; "
            "got a row with timestamp=None — use --timespans alltime for "
            "timestamp-less sources"
        )
    if isinstance(ts, _dt.datetime):
        return ts.date()
    if isinstance(ts, _dt.date):
        return ts
    # Epoch milliseconds, the shape the reference's commented ingest
    # produced (reference heatmap.py:26).
    return _dt.datetime.fromtimestamp(float(ts) / 1000.0, _dt.timezone.utc).date()


class TimespanVocab:
    """Host-side label <-> dense int id map (id 0 is always 'alltime')."""

    def __init__(self):
        self._labels = [ALLTIME]
        self._ids = {ALLTIME: 0}

    def __len__(self):
        return len(self._labels)

    @property
    def labels(self):
        return tuple(self._labels)

    def id_for(self, label: str) -> int:
        tid = self._ids.get(label)
        if tid is None:
            tid = len(self._labels)
            self._labels.append(label)
            self._ids[label] = tid
        return tid

    def label_for(self, tid: int) -> str:
        return self._labels[tid]

    def label_ids(self, timespan_type: str, timestamps) -> np.ndarray:
        """Per-point label ids for one timespan type.

        'alltime' ignores timestamps entirely (and tolerates None, like
        the reference whose timestamps are carried but unused,
        SURVEY.md §8.7). Numeric epoch-ms columns are factorized to
        unique UTC days first, so Python label formatting runs per
        distinct day, not per row.
        """
        n = len(timestamps)
        if timespan_type == "alltime":
            return np.zeros(n, np.int32)
        arr = np.asarray(timestamps)
        if arr.dtype.kind == "M" and n:
            # datetime64 columns (Parquet/Arrow): epoch ms. NaT casts
            # to INT64_MIN == TS_MISSING, so missing values flow into
            # the sentinel check below for free.
            arr = arr.astype("datetime64[ms]").astype(np.int64)
        if arr.dtype.kind in "iuf" and n:
            # Missing rows (sentinel / NaN) fail like the object path's
            # timestamp=None does — a dated bucket can't be invented.
            missing = (
                np.isnan(arr) if arr.dtype.kind == "f" else arr == TS_MISSING
            )
            if missing.any():
                _to_date(None)  # raises with the canonical guidance
            # Epoch ms -> UTC day ordinal; floor (not truncation)
            # matches fromtimestamp(ms/1000, UTC).date() for negatives.
            if arr.dtype.kind == "f":
                days = np.floor(arr / 86_400_000.0).astype(np.int64)
            else:
                days = np.floor_divide(arr.astype(np.int64), 86_400_000)
            uniq, inv = np.unique(days, return_inverse=True)
            per_day = np.empty(len(uniq), np.int32)
            for j, d in enumerate(uniq):
                date = _dt.datetime.fromtimestamp(
                    int(d) * 86_400, _dt.timezone.utc
                ).date()
                per_day[j] = self.id_for(timespan_label(timespan_type, date))
            return per_day[inv.reshape(-1)].astype(np.int32)
        out = np.empty(n, np.int32)
        for i, ts in enumerate(timestamps):
            out[i] = self.id_for(timespan_label(timespan_type, _to_date(ts)))
        return out
