"""HMPB: the framework's binary columnar point format (mmap ingest).

The port's copy of heatmap_tpu/io/hmpb.py: it writes the same file
bytes as the JAX package and reads files either package wrote.

CSV decoding tops out at parser speed (native/pointcodec.cpp);
production-scale reruns of the same dataset shouldn't pay it twice.
HMPB stores points in the pipeline's *fast layout* — numeric
columns plus pre-routed integer group ids (reference heatmap.py:64-70
routing applied once, at conversion) — so ingest is a memory map and
per-batch slicing runs at memory bandwidth. The reference's analog is
the Cassandra SSTable scan behind the connector (reference
heatmap.py:137), which it re-decodes every run.

Layout (explicitly little-endian, including on big-endian hosts):

    magic   b"HMPB\\x01\\n"
    u64     header_len (JSON bytes, excluding its pad)
    bytes   header JSON: {"n": N, "names": [routed group names],
                          "columns": [...]}  (id order; names[i] is
                          routed id i, -1 = excluded x-user),
            NUL-padded so the data section starts 8-byte aligned
    f64[N]  latitude
    f64[N]  longitude
    f64[N]  value (OPTIONAL: per-point weight, weighted jobs)
    i64[N]  timestamp (TS_MISSING sentinel = INT64_MIN)
    i32[N]  routed group id
    u8[N]   background flag (reference heatmap.py:28-29)

Sections are contiguous, in the order above (widest first, u8 last);
the header's ``columns`` list names exactly the sections present, in
file order, so readers compute offsets from the header (files without
the optional value column list five columns and older readers of such
files see the original layout unchanged). Every column is *naturally*
aligned for its element type — the data section starts 8-byte aligned,
f64/i64 sections keep that, and the narrower sections follow
widest-first — so external readers can mmap and cast each column
pointer directly.

Timestamp units: values pass through from the source unchanged
(the reference's location feed carried epoch-milliseconds, reference
heatmap.py:26); datetime/date objects are normalized to epoch-ms.
The column is self-consistent per file, but HMPB does not convert
between source unit conventions — mixing epoch-second and epoch-ms
sources and then using dated timespans is on the operator.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from heatmap_tpu_torch import native

MAGIC = b"HMPB\x01\n"
# Canonical missing-timestamp sentinel (INT64_MIN); re-exported here
# because it is part of the on-disk format contract.
from heatmap_tpu_torch.pipeline.timespan import TS_MISSING  # noqa: E402

_COLUMNS = (
    ("latitude", "<f8"),
    ("longitude", "<f8"),
    ("timestamp", "<i8"),
    ("routed", "<i4"),
    ("background", "u1"),
)

#: Every column an HMPB header may name, with its storage dtype. The
#: file's actual layout is the header's ``columns`` list in order.
_COLUMN_DTYPES = dict(_COLUMNS) | {"value": "<f8"}


def write_hmpb(path: str, latitude, longitude, routed, names,
               timestamp=None, background=None, value=None):
    """Write one HMPB file from fast-layout columns (atomic rename).

    ``value`` (optional f64 per-point weights) adds the value section —
    readers expose it and weighted fast jobs consume it; files without
    it keep the original five-column layout byte-for-byte."""
    lat = np.ascontiguousarray(latitude, "<f8")
    lon = np.ascontiguousarray(longitude, "<f8")
    n = lat.shape[0]
    rid = np.ascontiguousarray(routed, "<i4")
    ts = (
        np.full(n, TS_MISSING, "<i8")
        if timestamp is None
        else np.ascontiguousarray(timestamp, "<i8")
    )
    bg = (
        np.zeros(n, "u1")
        if background is None
        else np.ascontiguousarray(background, "u1")
    )
    val = None if value is None else np.ascontiguousarray(value, "<f8")
    sections = [("latitude", lat), ("longitude", lon)]
    if val is not None:
        sections.append(("value", val))
    sections += [("timestamp", ts), ("routed", rid), ("background", bg)]
    for name, arr in sections[1:]:
        if arr.shape[0] != n:
            raise ValueError(f"{name} has {arr.shape[0]} rows, expected {n}")
    if rid.size and int(rid.max(initial=-1)) >= len(names):
        raise ValueError("routed ids exceed the names table")
    header = json.dumps({
        "n": int(n),
        "names": list(names),
        "columns": [c for c, _ in sections],
    }).encode()
    # NUL-pad so the data section (magic + u64 + header + pad) starts
    # 8-byte aligned: every later section is then aligned too (columns
    # are ordered widest-first).
    pad = (-(len(MAGIC) + 8 + len(header))) % 8
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint64(len(header)).astype("<u8").tobytes())
        f.write(header)
        f.write(b"\x00" * pad)
        for _, arr in sections:
            arr.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class HMPBSource:
    """Memory-mapped HMPB reader yielding fast-layout batches.

    ``fast_batches`` is the pipeline.run_job_fast input contract
    (latitude/longitude/timestamp/background/routed arrays +
    new_group_names); ``batches`` adapts to the string-column Source
    contract for the generic (slower) pipeline paths.
    """

    #: Resident host bytes/point under FAST ingest: the mmap'd columns
    #: are page-cache (reclaimable), and only the per-batch routed
    #: views materialize (~28 B: f64 coords + i32 group + i64 stamp).
    #: Consulted by pipeline._auto_points_in_flight(fast=True) so a
    #: big HMPB file that fits single-shot is not demoted to the
    #: chunked path by the 160 B string-ingest constant.
    fast_host_bytes_per_point = 30

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not an HMPB file")
            (hlen,) = np.frombuffer(f.read(8), "<u8")
            if int(hlen) > size:
                raise ValueError(
                    f"{path}: corrupt header length {int(hlen)} "
                    f"(file is {size} bytes)"
                )
            try:
                header = json.loads(f.read(int(hlen)).decode())
                self.n = int(header["n"])
                self.names = list(header["names"])
                columns = list(header.get("columns")
                               or [c for c, _ in _COLUMNS])
            except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
                # json.JSONDecodeError is a ValueError; surface every
                # header-corruption shape as one clean error.
                raise ValueError(f"{path}: corrupt HMPB header: {e}") from e
            if self.n < 0:
                raise ValueError(f"{path}: corrupt HMPB header: n={self.n}")
            unknown = [c for c in columns if c not in _COLUMN_DTYPES]
            if unknown:
                raise ValueError(
                    f"{path}: HMPB header names unknown column(s) "
                    f"{unknown} (written by a newer format revision?)"
                )
            required = [c for c, _ in _COLUMNS]
            missing = [c for c in required if c not in columns]
            if missing or len(set(columns)) != len(columns):
                raise ValueError(
                    f"{path}: corrupt HMPB header: columns={columns} "
                    f"(missing {missing or 'none'}, duplicates "
                    f"{'present' if len(set(columns)) != len(columns) else 'none'})"
                )
            self._data_off = f.tell() + (-f.tell()) % 8  # header NUL pad
        self.has_value = "value" in columns
        offsets = {}
        off = self._data_off
        for name in columns:
            dtype = _COLUMN_DTYPES[name]
            offsets[name] = (off, dtype)
            off += self.n * np.dtype(dtype).itemsize
        expected = off
        if size < expected:
            raise ValueError(
                f"{path}: truncated ({size} bytes, need {expected})"
            )
        # Map the file once; per-batch reads are plain slices of these
        # column views (no per-batch open/mmap syscalls).
        self._mm = np.memmap(path, dtype="u1", mode="r")
        self._cols = {
            name: self._mm[o : o + self.n * np.dtype(dt).itemsize].view(dt)
            for name, (o, dt) in offsets.items()
        }
        self._maps = offsets  # column offset table (alignment contract)

    def _col(self, name, lo, hi):
        return self._cols[name][lo:hi]

    def close(self) -> None:
        """Release the file map. The source yields no batches after
        this. Drops the source's own references only — the map is
        unmapped by refcount immediately when no batch views escaped
        (the cli probe case), or as soon as outstanding zero-copy batch
        views die. Never force-closes the mmap: numpy memmap views
        don't pin the buffer against ``mmap.close()``, so forcing it
        would turn a held view into a segfault."""
        self._cols = {}
        self._mm = None
        self.n = 0  # closed source iterates as empty, not KeyError

    def fast_batches(self, batch_size: int = 1 << 20):
        sent_names = False
        for lo in range(0, self.n, batch_size):
            hi = min(lo + batch_size, self.n)
            out = {
                "latitude": np.asarray(self._col("latitude", lo, hi)),
                "longitude": np.asarray(self._col("longitude", lo, hi)),
                "timestamp": np.asarray(self._col("timestamp", lo, hi)),
                "routed": np.asarray(self._col("routed", lo, hi)),
                "background": np.asarray(
                    self._col("background", lo, hi)
                ).astype(bool),
                "new_group_names": [] if sent_names else list(self.names),
            }
            if self.has_value:
                out["value"] = np.asarray(self._col("value", lo, hi))
            yield out
            sent_names = True

    def batches(self, batch_size: int = 1 << 20):
        """String-column Source view (for the generic pipeline paths).

        user_id strings are reconstructed from the routed-name table —
        excluded x-users come back as the canonical ``"x"`` (the
        original id wasn't stored; routing is identical since only the
        prefix matters, reference heatmap.py:65) and route-pooled ids
        as ``"rt-"``-less ``"route"``... which would re-route to its own
        group, so they come back as ``"rt-0"`` to preserve routing.
        """
        for b in self.fast_batches(batch_size):
            rid = b["routed"]
            users = []
            for r in rid:
                if r < 0:
                    users.append("x")
                else:
                    name = self.names[r]
                    users.append("rt-0" if name == "route" else name)
            ts = b["timestamp"]
            out = {
                "latitude": b["latitude"],
                "longitude": b["longitude"],
                "user_id": users,
                "source": [
                    "background" if bg else "gps" for bg in b["background"]
                ],
                "timestamp": [
                    None if t == TS_MISSING else int(t) for t in ts
                ],
            }
            if "value" in b:
                out["value"] = b["value"]
            yield out


@dataclasses.dataclass
class HMPBDirSource:
    """A directory of ``*.hmpb`` shard files as one source.

    The multi-file analog of Cassandra token ranges for binary point
    data: each file is a deterministic range unit, so the source is
    range-shardable (``shard_index``/``shard_count`` interleave files
    across hosts). Per-file name tables are remapped into one
    global intern as files stream, so ``fast_batches`` keeps the
    run_job_fast contract (routed ids index the cumulative
    ``new_group_names`` stream; ids stay stable across files).
    """

    #: See HMPBSource.fast_host_bytes_per_point (files stream one at a
    #: time, so the per-point residency matches the single-file case).
    fast_host_bytes_per_point = 30

    path: str
    shard_index: int = 0
    shard_count: int = 1

    def __post_init__(self):
        if self.shard_count < 1 or not (
            0 <= self.shard_index < self.shard_count
        ):
            raise ValueError(
                f"invalid shard assignment: shard_index={self.shard_index} "
                f"shard_count={self.shard_count} (need 0 <= index < count)"
            )
        self.files = sorted(
            os.path.join(self.path, f)
            for f in os.listdir(self.path)
            if f.endswith(".hmpb")
        )
        if not self.files:
            raise ValueError(f"no .hmpb files under {self.path!r}")

    def my_files(self):
        """This shard's interleaved (global_index, path) assignment."""
        return [
            (i, f) for i, f in enumerate(self.files)
            if i % self.shard_count == self.shard_index
        ]

    def fast_batches(self, batch_size: int = 1 << 20):
        intern: dict = {}
        names: list = []
        emitted = 0
        for _, path in self.my_files():
            src = HMPBSource(path)
            # file-local id -> global id (global intern grows in
            # first-seen order, matching the reader contract).
            local_to_global = np.empty(max(len(src.names), 1), np.int32)
            for li, name in enumerate(src.names):
                gi = intern.get(name)
                if gi is None:
                    gi = len(names)
                    intern[name] = gi
                    names.append(name)
                local_to_global[li] = gi
            # convert_to_hmpb writes every part with the SAME names
            # table, so the remap is usually the identity — skip the
            # per-batch copies then (mmap ingest stays copy-free).
            identity = (
                len(src.names) <= len(names)
                and bool(
                    (local_to_global[: len(src.names)]
                     == np.arange(len(src.names))).all()
                )
            )
            try:
                for b in src.fast_batches(batch_size):
                    routed = np.asarray(b["routed"], np.int32)
                    if not identity:
                        routed = np.where(
                            routed >= 0,
                            local_to_global[np.maximum(routed, 0)], -1,
                        ).astype(np.int32)
                    out = {
                        "latitude": b["latitude"],
                        "longitude": b["longitude"],
                        "timestamp": b["timestamp"],
                        "routed": routed,
                        "background": b["background"],
                        "new_group_names": names[emitted:],
                    }
                    if "value" in b:
                        out["value"] = b["value"]
                    yield out
                    emitted = len(names)
            finally:
                # Unmap each shard as soon as its batches are consumed
                # instead of accumulating every file's map until GC
                # (close tolerates consumers still holding batch views).
                src.close()

    def close(self) -> None:
        """No held maps: per-file sources open and close per iteration."""

    def batches(self, batch_size: int = 1 << 20):
        """String-column Source view over this shard's files."""
        for _, path in self.my_files():
            yield from HMPBSource(path).batches(batch_size)


def _stamp_to_i64(s) -> int:
    """Timestamp -> stored i64: ints/strings pass through as epoch
    values; datetime/date become epoch-ms (the shape timespan._to_date
    consumes — reference heatmap.py:26 carried epoch-ms)."""
    import datetime as _dt

    if s in (None, ""):
        return TS_MISSING
    if isinstance(s, _dt.datetime):
        if s.tzinfo is None:
            s = s.replace(tzinfo=_dt.timezone.utc)
        return int(s.timestamp() * 1000)
    if isinstance(s, _dt.date):
        return int(_dt.datetime(
            s.year, s.month, s.day, tzinfo=_dt.timezone.utc
        ).timestamp() * 1000)
    return int(float(s))


def convert_to_hmpb(source_spec: str, out_path: str,
                    batch_size: int = 1 << 20,
                    shard_rows: int | None = None) -> dict:
    """Convert any source spec to HMPB (columns held in memory once).

    CSV inputs use the native decoder's fast path end-to-end; other
    sources route user ids host-side. With ``shard_rows``, ``out_path``
    becomes a DIRECTORY of ``part-NNNNN.hmpb`` files of at most that
    many rows each (the HMPBDirSource range-shard layout for multihost
    ingest); every part carries the full shared names table, so parts
    are independently readable and ids are consistent without
    remapping. Returns {"n": ..., "groups": ...}.
    """
    if shard_rows is not None and shard_rows < 1:
        raise ValueError(f"shard_rows must be >= 1, got {shard_rows}")
    lats, lons, tss, rids, bgs, vals = [], [], [], [], [], []
    names: list = []

    def ingest_fast(batches):
        for b in batches:
            names.extend(b["new_group_names"])
            lats.append(np.asarray(b["latitude"], np.float64))
            lons.append(np.asarray(b["longitude"], np.float64))
            tss.append(np.asarray(b["timestamp"], np.int64))
            rids.append(np.asarray(b["routed"], np.int32))
            bgs.append(np.asarray(b["background"], np.uint8))
            if "value" in b:
                vals.append(np.asarray(b["value"], np.float64))

    kind, _, rest = source_spec.partition(":")
    is_csv = kind == "csv" or (not rest and source_spec.endswith(".csv"))
    is_hmpb = kind == "hmpb" or (not rest and source_spec.endswith(".hmpb"))
    native_ok = False
    if is_csv and native.available():
        # The native decoder knows the reference columns only; a
        # weighted CSV must take the string path so its value column
        # lands in the HMPB file.
        from heatmap_tpu_torch.io.sources import CSVSource

        native_ok = not CSVSource(rest or source_spec).has_value_column()
    if native_ok:
        ingest_fast(native.parse_csv_batches(
            rest if kind == "csv" else source_spec, batch_size, fast=True,
        ))
    elif is_hmpb:
        # Already in the fast layout: columnar copy, no per-row work.
        ingest_fast(HMPBSource(rest or source_spec).fast_batches(batch_size))
    else:
        from heatmap_tpu_torch.io.sources import open_source
        from heatmap_tpu_torch.pipeline.groups import route_user

        src = open_source(source_spec)
        intern: dict = {}
        for b in src.batches(batch_size):
            m = len(b["latitude"])
            rid = np.empty(m, np.int32)
            for i, uid in enumerate(b["user_id"]):
                name = route_user(uid)
                if name is None:
                    rid[i] = -1
                    continue
                g = intern.get(name)
                if g is None:
                    g = len(names)
                    intern[name] = g
                    names.append(name)
                rid[i] = g
            src_col = b.get("source") or []
            bg = np.asarray(
                [s == "background" for s in src_col] if len(src_col) else
                np.zeros(m, bool)
            ).astype(np.uint8)
            stamps = b.get("timestamp")
            if stamps is None or len(stamps) == 0:
                ts = np.full(m, TS_MISSING, np.int64)
            else:
                ts = np.asarray([_stamp_to_i64(s) for s in stamps], np.int64)
            lats.append(np.asarray(b["latitude"], np.float64))
            lons.append(np.asarray(b["longitude"], np.float64))
            tss.append(ts)
            rids.append(rid)
            bgs.append(bg)
            if "value" in b:
                vals.append(np.asarray(b["value"], np.float64))

    n = sum(len(a) for a in lats)
    if vals and sum(len(a) for a in vals) != n:
        # All-or-nothing: a partial value column would silently mean
        # "weight 1.0" for whole slices of the dataset.
        raise ValueError(
            f"{source_spec}: value column present on only part of the "
            "source batches; cannot write a consistent HMPB value "
            "section"
        )
    lat = np.concatenate(lats) if n else np.empty(0)
    lon = np.concatenate(lons) if n else np.empty(0)
    rid = np.concatenate(rids) if n else np.empty(0, np.int32)
    ts = np.concatenate(tss) if n else None
    bg = np.concatenate(bgs) if n else None
    val = np.concatenate(vals) if (n and vals) else None
    if shard_rows is None:
        write_hmpb(out_path, lat, lon, rid, names,
                   timestamp=ts, background=bg, value=val)
        return {"n": n, "groups": len(names), "output": out_path}
    os.makedirs(out_path, exist_ok=True)
    n_parts = max(1, -(-n // shard_rows))
    # A re-convert with fewer parts must not leave stale shards behind:
    # HMPBDirSource reads every *.hmpb in the directory as data.
    for f in os.listdir(out_path):
        if f.endswith(".hmpb"):
            os.remove(os.path.join(out_path, f))
    for p in range(n_parts):
        lo, hi = p * shard_rows, min((p + 1) * shard_rows, max(n, 0))
        write_hmpb(
            os.path.join(out_path, f"part-{p:05d}.hmpb"),
            lat[lo:hi], lon[lo:hi], rid[lo:hi], names,
            timestamp=None if ts is None else ts[lo:hi],
            background=None if bg is None else bg[lo:hi],
            value=None if val is None else val[lo:hi],
        )
    return {"n": n, "groups": len(names), "output": out_path,
            "parts": n_parts}
