"""ctypes bindings to the repo's native runtime library (native/*.cpp).

The port's copy of heatmap_tpu/native.py. The library is the same C++
runtime that the JAX package loads:

- ``parse_csv_batches``: threaded CSV point decoder with batch prefetch
  (native/pointcodec.cpp), in the compat layout or the integer fast
  layout;
- ``format_blob_bodies`` and ``format_blob_ids``: threaded formatters of
  the JSON blob documents and their ``user|timespan|z_r_c`` ids
  (native/blobfmt.cpp);
- ``decode_keys``: the fused composite-key split and Morton decode
  (native/leveldecode.cpp);
- ``StagingPool``: a bounded pool of page-aligned host buffers
  (native/staging.cpp).

Nothing happens at import. The first call that needs the library (or
``available()``) runs ``make -C native`` from the sources in this
checkout, under an exclusive file lock so that parallel processes build
it once, and loads ``native/build/libheatmap_native.so``. Without a
toolchain or the sources ``available()`` is False, the bound functions
raise, and callers take their numpy paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Iterator

import numpy as np

from heatmap_tpu_torch.pipeline.timespan import TS_MISSING

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
LIB_NAME = "libheatmap_native.so"

_load_lock = threading.Lock()
_lib = None
_loaded = False

_c_dbl = ctypes.POINTER(ctypes.c_double)
_c_i64 = ctypes.POINTER(ctypes.c_int64)
_c_i32 = ctypes.POINTER(ctypes.c_int32)
_c_u8 = ctypes.POINTER(ctypes.c_uint8)


def build(native_dir: str = NATIVE_DIR) -> str | None:
    """Run ``make -C native_dir`` under an exclusive lock on
    ``native_dir/build/.build.lock``; returns the library's path, or
    None when the build failed or there is nothing to build.

    The lock serialises every process that builds through this function:
    the first one compiles, and the others then find the library up to
    date and compile nothing.
    """
    if not os.path.isfile(os.path.join(native_dir, "Makefile")):
        return None
    build_dir = os.path.join(native_dir, "build")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            rc = subprocess.call(["make", "-C", native_dir],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
        except OSError:
            rc = -1
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    path = os.path.join(build_dir, LIB_NAME)
    return path if rc == 0 and os.path.exists(path) else None


def _declare(lib) -> None:
    """argtypes and restype of every entry point the bindings call."""
    sig = {
        "hm_csv_open": (ctypes.c_void_p, [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]),
        "hm_csv_peek": (ctypes.c_int64, [
            ctypes.c_void_p, _c_i64, _c_i64, _c_i64]),
        "hm_csv_take": (ctypes.c_int, [
            ctypes.c_void_p, _c_dbl, _c_dbl, _c_i64, ctypes.c_char_p,
            ctypes.c_char_p, _c_i32, _c_u8, ctypes.c_char_p]),
        "hm_csv_error": (ctypes.c_char_p, [ctypes.c_void_p]),
        "hm_csv_close": (None, [ctypes.c_void_p]),
        "hm_ts_missing": (ctypes.c_int64, []),
        "hm_pool_create": (ctypes.c_void_p, [ctypes.c_int64, ctypes.c_int]),
        "hm_pool_acquire": (ctypes.c_int, [ctypes.c_void_p]),
        "hm_pool_try_acquire": (ctypes.c_int, [ctypes.c_void_p]),
        "hm_pool_release": (None, [ctypes.c_void_p, ctypes.c_int]),
        "hm_pool_buffer": (ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int]),
        "hm_pool_buf_bytes": (ctypes.c_int64, [ctypes.c_void_p]),
        "hm_pool_size": (ctypes.c_int, [ctypes.c_void_p]),
        "hm_pool_destroy": (None, [ctypes.c_void_p]),
        "hm_format_blob_bodies": (ctypes.c_int64, [
            _c_i64, _c_i64, _c_dbl, _c_u8, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p)]),
        "hm_format_blob_ids": (ctypes.c_int64, [
            _c_i32, _c_i32, _c_i32, _c_i32, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_char_p, _c_i64, ctypes.c_int32, ctypes.c_char_p,
            _c_i64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_char_p)]),
        "hm_blobfmt_free": (None, [ctypes.c_char_p]),
        "hm_decode_keys": (ctypes.c_int32, [
            _c_i64, ctypes.c_int64, ctypes.c_int32, _c_i32, _c_i64, _c_i32,
            _c_i32, ctypes.c_int32]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _load():
    path = build()
    if path is None:
        path = os.path.join(NATIVE_DIR, "build", LIB_NAME)
        if not os.path.exists(path):
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    _declare(lib)
    # The C sentinel must agree with the port's own, or fast-path
    # missing timestamps would silently stop being detected.
    if int(lib.hm_ts_missing()) != int(TS_MISSING):
        raise RuntimeError(
            f"native TS_MISSING {int(lib.hm_ts_missing())} != the port's "
            f"{int(TS_MISSING)} (pipeline/timespan.py)")
    return lib


def _library():
    """The loaded library, or None; built and loaded on the first call."""
    global _lib, _loaded
    with _load_lock:
        if not _loaded:
            _lib = _load()
            _loaded = True
    return _lib


def available() -> bool:
    """True when the native library builds and loads."""
    return _library() is not None


def _require():
    lib = _library()
    if lib is None:
        raise RuntimeError(
            "the native library is unavailable (make -C native failed or "
            "no toolchain); check native.available() first")
    return lib


def _arena_to_list(buf: bytes, rows: int) -> list:
    # NUL-separated fields, one per row, each NUL-terminated.
    if rows == 0:
        return []
    return buf[:-1].decode("utf-8", "replace").split("\x00")


def parse_csv_batches(path: str, batch_size: int, queue_depth: int = 3,
                      fast: bool = False,
                      n_workers: int | None = None) -> Iterator[dict]:
    """Columnar batches from a CSV file via the native decoder.

    The default (compat) layout is the io.sources batch layout, with
    timestamps as Python ints (None where missing or blank).

    ``fast=True`` keeps everything integer: ``latitude``/``longitude``
    (f64), ``timestamp`` (i64, TS_MISSING sentinel), ``background``
    (bool; reference heatmap.py:28-29), ``routed`` (i32 ids into the
    reader's routed-group name table, -1 = excluded x-user; reference
    heatmap.py:64-70) and ``new_group_names``, the names not yet sent,
    in id order.

    ``n_workers`` defaults to 1 in compat mode (batch order then matches
    the Python reader) and to the CPU count (at most 8) in fast mode,
    where the file is parsed in parallel byte ranges and the batch order
    of files over 1 MiB varies run to run.
    """
    import csv as _csv

    lib = _require()
    with open(path, newline="") as f:
        header = next(_csv.reader(f), None)
    if header is None:  # zero-byte file: nothing to yield
        return

    def col(name):
        try:
            return header.index(name)
        except ValueError:
            return -1

    lat_c, lon_c = col("latitude"), col("longitude")
    if lat_c < 0 or lon_c < 0:
        raise ValueError(f"{path}: missing latitude/longitude columns")
    if n_workers is None:
        n_workers = min(8, os.cpu_count() or 1) if fast else 1
    handle = lib.hm_csv_open(
        path.encode(), batch_size, lat_c, lon_c, col("user_id"),
        col("source"), col("timestamp"), queue_depth, 0 if fast else 1,
        n_workers)
    if not handle:
        raise OSError(f"native csv open failed for {path}")
    try:
        while True:
            uid_b = ctypes.c_int64()
            src_b = ctypes.c_int64()
            names_b = ctypes.c_int64()
            rows = lib.hm_csv_peek(handle, ctypes.byref(uid_b),
                                   ctypes.byref(src_b), ctypes.byref(names_b))
            if rows == 0:
                return
            if rows < 0:
                err = lib.hm_csv_error(handle)
                raise OSError(f"native csv parse failed for {path}: "
                              f"{(err or b'').decode()}")
            lat = np.empty(rows, np.float64)
            lon = np.empty(rows, np.float64)
            ts = np.empty(rows, np.int64)
            if fast:
                routed = np.empty(rows, np.int32)
                bg = np.empty(rows, np.uint8)
                names_arena = ctypes.create_string_buffer(max(1, names_b.value))
                rc = lib.hm_csv_take(
                    handle, lat.ctypes.data_as(_c_dbl),
                    lon.ctypes.data_as(_c_dbl), ts.ctypes.data_as(_c_i64),
                    None, None, routed.ctypes.data_as(_c_i32),
                    bg.ctypes.data_as(_c_u8), names_arena)
                if rc != 0:
                    raise OSError("native csv take failed (no pending batch)")
                yield {
                    "latitude": lat,
                    "longitude": lon,
                    "timestamp": ts,
                    "background": bg.astype(bool),
                    "routed": routed,
                    "new_group_names": _arena_to_list(
                        names_arena.raw[: names_b.value],
                        1 if names_b.value else 0),
                }
                continue
            uid_arena = ctypes.create_string_buffer(max(1, uid_b.value))
            src_arena = ctypes.create_string_buffer(max(1, src_b.value))
            rc = lib.hm_csv_take(
                handle, lat.ctypes.data_as(_c_dbl),
                lon.ctypes.data_as(_c_dbl), ts.ctypes.data_as(_c_i64),
                uid_arena, src_arena, None, None, None)
            if rc != 0:
                raise OSError("native csv take failed (no pending batch)")
            if (ts == TS_MISSING).any():
                stamps = [None if t == TS_MISSING else int(t)
                          for t in ts.tolist()]
            else:
                stamps = ts.tolist()
            yield {
                "latitude": lat,
                "longitude": lon,
                "user_id": _arena_to_list(uid_arena.raw[: uid_b.value], rows),
                "source": _arena_to_list(src_arena.raw[: src_b.value], rows),
                "timestamp": stamps,
            }
    finally:
        lib.hm_csv_close(handle)


class StagingPool:
    """Bounded pool of page-aligned host staging buffers.

    ``acquire(shape, dtype)`` returns ``(id, array)``, the array a
    zero-copy numpy view of a pooled buffer; release the id once its data
    has been handed on. Blocks while every buffer is out. ``close()``
    refuses while ids are outstanding, since their views would dangle.
    """

    def __init__(self, buf_bytes: int, n_bufs: int = 2):
        self._lib = _require()
        self._h = self._lib.hm_pool_create(buf_bytes, n_bufs)
        if not self._h:
            raise MemoryError("staging pool allocation failed")
        self.buf_bytes = int(self._lib.hm_pool_buf_bytes(self._h))
        self.n_bufs = int(self._lib.hm_pool_size(self._h))
        self._outstanding = set()

    def acquire(self, shape, dtype, block: bool = True):
        dtype = np.dtype(dtype)
        count = int(np.prod(shape))
        if count * dtype.itemsize > self.buf_bytes:
            raise ValueError(f"requested {count * dtype.itemsize} bytes > "
                             f"pool buffer {self.buf_bytes}")
        if block:
            bid = self._lib.hm_pool_acquire(self._h)
        else:
            bid = self._lib.hm_pool_try_acquire(self._h)
            if bid < 0:
                return None
        base = self._lib.hm_pool_buffer(self._h, bid)
        raw = (ctypes.c_char * self.buf_bytes).from_address(base)
        arr = np.frombuffer(raw, dtype=dtype, count=count)
        self._outstanding.add(bid)
        return bid, arr.reshape(shape)

    def release(self, bid: int):
        self._outstanding.discard(bid)
        self._lib.hm_pool_release(self._h, bid)

    def close(self, force: bool = False):
        if getattr(self, "_h", None):
            if self._outstanding and not force:
                raise RuntimeError(
                    f"staging pool closed with buffers "
                    f"{sorted(self._outstanding)} still acquired; release "
                    "them first (or close(force=True) if they are dead)")
            self._lib.hm_pool_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close(force=True)
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _take_buffer(lib, out, length) -> bytes:
    try:
        return ctypes.string_at(out, length)
    finally:
        lib.hm_blobfmt_free(out)


def format_blob_bodies(rows, cols, values, is_start, zoom: int,
                       n_threads: int | None = None) -> list:
    """The '{...}' JSON documents of one sorted level, one per blob
    start, aggregate order kept. ``values`` must be integral doubles with
    |v| < 1e15 (the caller checks): "%lld.0" is then exactly repr(float).
    """
    n = len(rows)
    if n == 0:
        return []
    lib = _require()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    values = np.ascontiguousarray(values, np.float64)
    starts = np.ascontiguousarray(is_start, np.uint8)
    if not (len(cols) == len(values) == len(starts) == n):
        raise ValueError("column length mismatch")
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    out = ctypes.c_char_p()
    length = lib.hm_format_blob_bodies(
        rows.ctypes.data_as(_c_i64), cols.ctypes.data_as(_c_i64),
        values.ctypes.data_as(_c_dbl), starts.ctypes.data_as(_c_u8),
        n, zoom, n_threads, ctypes.byref(out))
    if length < 0:
        raise MemoryError("native blob formatter allocation failed")
    return _take_buffer(lib, out, length).decode("ascii").split("\x00")


def _name_table(names):
    """UTF-8 concat buffer + int64 offsets for a small name array."""
    encoded = [str(s).encode("utf-8") for s in names]
    offs = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(b) for b in encoded], out=offs[1:])
    return b"".join(encoded), offs


def format_blob_ids(user_idx, ts_idx, coarse_row, coarse_col,
                    coarse_zoom: int, user_names, ts_names,
                    n_threads: int | None = None) -> list:
    """'user|timespan|z_r_c' blob ids, dictionary-decoded and formatted
    in one threaded C pass (reference key codec heatmap.py:54-55)."""
    n = len(user_idx)
    if not (len(ts_idx) == len(coarse_row) == len(coarse_col) == n):
        raise ValueError(
            f"column length mismatch: user_idx={n} ts_idx={len(ts_idx)} "
            f"coarse_row={len(coarse_row)} coarse_col={len(coarse_col)}")
    if n == 0:
        return []
    lib = _require()
    user_idx = np.ascontiguousarray(user_idx, np.int32)
    ts_idx = np.ascontiguousarray(ts_idx, np.int32)
    coarse_row = np.ascontiguousarray(coarse_row, np.int32)
    coarse_col = np.ascontiguousarray(coarse_col, np.int32)
    ubuf, uoffs = _name_table(user_names)
    tbuf, toffs = _name_table(ts_names)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    out = ctypes.c_char_p()
    length = lib.hm_format_blob_ids(
        user_idx.ctypes.data_as(_c_i32), ts_idx.ctypes.data_as(_c_i32),
        coarse_row.ctypes.data_as(_c_i32), coarse_col.ctypes.data_as(_c_i32),
        n, coarse_zoom, ubuf, uoffs.ctypes.data_as(_c_i64), len(user_names),
        tbuf, toffs.ctypes.data_as(_c_i64), len(ts_names), n_threads,
        ctypes.byref(out))
    if length == -1:
        raise MemoryError("native blob-id formatter allocation failed")
    if length == -2:
        raise ValueError(
            "blob-id dictionary index out of range for its name table")
    if length < 0:
        raise ValueError(f"coarse_zoom out of range: {coarse_zoom}")
    return _take_buffer(lib, out, length).decode("utf-8").split("\x00")[:-1]


def decode_keys(keys, code_bits: int, n_threads: int | None = None,
                morton_only: bool = False):
    """Split composite cascade keys -> (slot int32, code int64, row int32,
    col int32) in one threaded pass. With ``morton_only`` the slot and
    code columns are neither written nor returned (None): a plain Morton
    decode. The caller guarantees ``keys >> code_bits`` fits int32.
    """
    keys = np.ascontiguousarray(keys, np.int64)
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {keys.shape}")
    n = len(keys)
    slot = None if morton_only else np.empty(n, np.int32)
    code = None if morton_only else np.empty(n, np.int64)
    row = np.empty(n, np.int32)
    col = np.empty(n, np.int32)
    if n:
        lib = _require()
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        rc = lib.hm_decode_keys(
            keys.ctypes.data_as(_c_i64), n, code_bits,
            None if slot is None else slot.ctypes.data_as(_c_i32),
            None if code is None else code.ctypes.data_as(_c_i64),
            row.ctypes.data_as(_c_i32), col.ctypes.data_as(_c_i32),
            n_threads)
        if rc != 0:
            raise ValueError(f"hm_decode_keys rejected code_bits={code_bits}")
    return slot, code, row, col
