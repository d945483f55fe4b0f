"""The job's ``{blob_id: json}`` dict in one native pass
(``csrc/blob_dict.cpp``).

``build`` hands every level's sorted columns, blob starts and name
tables to the library at once. It writes each blob id and each body
straight into its own ``str`` (threads count and fill, the GIL released)
and inserts the pairs into one dict presized for the job, in level order
then blob order: the dict that formatting each level, splitting the text
and ``dict.update`` give, key order included. Values must be integral
doubles with |v| < 1e15 (the caller checks).

Nothing happens at import. The first ``available()`` builds the library
with ``g++`` against the interpreter's headers (``_build.load_host``);
without a compiler or the headers it is False and callers take the
numpy path.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from heatmap_tpu_torch import _build

#: int64 fields a level in the meta array, in ``csrc/blob_dict.cpp``'s
#: ``Field`` order.
_FIELDS = 17

_lock = threading.Lock()
_lib = None
_loaded = False


def _load():
    try:
        lib = _build.load_host("blob_dict")
    except (RuntimeError, OSError):
        return None
    fn = lib.hm_blob_dict
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.py_object,
                   ctypes.py_object, ctypes.c_int32]
    fn.restype = ctypes.py_object
    return lib


def _library():
    """The loaded library, or None; built and loaded on the first call."""
    global _lib, _loaded
    with _lock:
        if not _loaded:
            _lib = _load()
            _loaded = True
    return _lib


def available() -> bool:
    """True when the library builds and loads."""
    return _library() is not None


def _int_pair(a, b):
    """Two integer columns as one width: both int32 as they are, else
    both int64; returns (a, b, wide)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == b.dtype == np.int32:
        return np.ascontiguousarray(a), np.ascontiguousarray(b), 0
    return (np.ascontiguousarray(a, np.int64),
            np.ascontiguousarray(b, np.int64), 1)


def build(runs, out: dict | None = None,
          n_threads: int | None = None) -> dict:
    """``{blob_id: json}`` of ``runs``, a list of ``(level, starts)``:
    a finalized level (``cascade.finalize_level_arrays``) and the int64
    indices of its blob runs' first entries, the first of them 0. With
    ``out`` the pairs go into that dict, after what it holds, and it is
    returned; else into a new one. Raises ValueError for a name index
    out of range or a bad start, MemoryError, and then returns nothing.
    """
    lib = _library()
    if lib is None:
        raise RuntimeError("the blob dict library is unavailable (g++ or "
                           "Python's headers missing); check available()")
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    meta = np.zeros((len(runs), _FIELDS), np.int64)
    keep, tables, table_of = [], [], {}

    def table(names) -> int:
        k = id(names)
        if k not in table_of:
            table_of[k] = len(tables)
            tables.append([str(s) for s in names])
            keep.append(names)  # ``id`` stays unique while this runs
        return table_of[k]

    for k, (lvl, starts) in enumerate(runs):
        rows, cols, entry_wide = _int_pair(lvl["row"], lvl["col"])
        uidx, tidx, idx_wide = _int_pair(lvl["user_idx"],
                                         lvl["timespan_idx"])
        crow, ccol, coarse_wide = _int_pair(lvl["coarse_row"],
                                            lvl["coarse_col"])
        vals = np.ascontiguousarray(lvl["value"], np.float64)
        starts = np.ascontiguousarray(starts, np.int64)
        n = len(rows)
        if not all(len(c) == n for c in (cols, uidx, tidx, crow, ccol,
                                         vals)):
            raise ValueError("column length mismatch")
        if starts.ndim != 1 or (n > 0) != (len(starts) > 0):
            raise ValueError("a level with entries needs its blob starts")
        keep.extend((rows, cols, uidx, tidx, crow, ccol, vals, starts))
        meta[k] = (n, len(starts), int(lvl["zoom"]), int(lvl["coarse_zoom"]),
                   table(lvl["user_names"]), table(lvl["timespan_names"]),
                   entry_wide, idx_wide, coarse_wide,
                   rows.ctypes.data, cols.ctypes.data, vals.ctypes.data,
                   starts.ctypes.data, uidx.ctypes.data, tidx.ctypes.data,
                   crow.ctypes.data, ccol.ctypes.data)
    return lib.hm_blob_dict(meta.ctypes.data, len(runs), tables, out,
                            n_threads)
