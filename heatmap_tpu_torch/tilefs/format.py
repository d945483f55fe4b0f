"""tilefs on-disk format: mmap-ready columnar per-zoom tile files.

The port's copy of heatmap_tpu/tilefs/format.py: for the same levels it
writes the same bytes, and it reads files either package wrote.

One ``tilefs-z{zoom:02d}.bin`` per detail zoom, laid out for zero-copy
serving: every (user, timespan) pair's Morton codes (int64) and values
(float64) are stored as contiguous 64-byte-aligned column segments,
already in the exact order :class:`heatmap_tpu_torch.serve.store.Level` would
hold them (stable argsort by code, duplicates preserved), so the reader
hands ``np.frombuffer`` views straight to the serve tier and a tile
render touches only the handful of pages its Morton range lives on —
N backends on one host share the kernel page cache instead of keeping
N heap copies of the pyramid.

Layout::

    [header 64B]  magic TILEFS1\\n | version | endian marker | zoom |
                  coarse_zoom | crc32(header)
    [segments]    per pair: codes int64[n], values float64[n],
                  each 64-byte aligned
    [footer]      JSON index: schema, zoom, coarse_zoom, pairs
                  [{user, timespan, n, codes_off, values_off, vmax,
                    codes_crc, values_crc}]
    [trailer 24B] footer_off u64 | footer_len u32 | crc32(footer) |
                  magic TILEFSIX

The trailer magic doubles as the store-sniffing hook (a truncated
write loses it, so a torn file is detected at open, not at page-fault
time); the per-segment crcs are only checked by :func:`verify_tilefs`
(the recovery sweep) so a healthy open stays lazy — no data pages are
touched until a tile actually needs them. Integer fields are written in
native byte order with an explicit marker; a reader on the other
endianness refuses the file rather than serving garbled codes.

Writes go through the repo-wide atomic discipline: stage to ``.tmp``,
``os.replace``, under the ``sink.write`` fault site. Numpy-only on
purpose (the serve-path contract): no torch import anywhere in this
package.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import zlib

import numpy as np

from heatmap_tpu_torch import faults

SCHEMA = "heatmap-tpu.tilefs.v1"
VERSION = 1
MAGIC = b"TILEFS1\n"
TRAILER_MAGIC = b"TILEFSIX"
#: Native-order sentinel; reads back permuted under the other
#: endianness, which is exactly the refusal signal we want.
ENDIAN_MARK = 0x01020304
HEADER_SIZE = 64
#: header fields before the crc (crc covers these bytes verbatim).
_HEADER_FMT = "=8sIIII"
_TRAILER_FMT = "=QII8s"
TRAILER_SIZE = struct.calcsize(_TRAILER_FMT)
_ALIGN = 64


class TilefsError(ValueError):
    """A tilefs file that must not be served: torn, truncated, wrong
    version, or wrong endianness. The store layer treats it as "fall
    back to the heap npz for this zoom"; the recovery sweep treats it
    as "quarantine"."""


def tilefs_path(dirpath: str, zoom: int) -> str:
    return os.path.join(dirpath, f"tilefs-z{int(zoom):02d}.bin")


def list_tilefs(dirpath: str) -> dict[int, str]:
    """{zoom: path} for every ``tilefs-z*.bin`` in ``dirpath``."""
    out: dict[int, str] = {}
    try:
        names = os.listdir(dirpath)
    except OSError:
        return out
    for name in sorted(names):
        if name.startswith("tilefs-z") and name.endswith(".bin"):
            try:
                zoom = int(name[len("tilefs-z"):-len(".bin")])
            except ValueError:
                continue
            out[zoom] = os.path.join(dirpath, name)
    return out


def sniff_tilefs(dirpath: str) -> bool:
    """True when ``dirpath`` holds at least one tilefs file with an
    intact trailer magic — the bare-path store-spec sniff (cheap: one
    stat + one 8-byte read per candidate, no footer parse)."""
    for path in list_tilefs(dirpath).values():
        try:
            with open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if size < HEADER_SIZE + TRAILER_SIZE:
                    continue
                f.seek(size - 8)
                if f.read(8) == TRAILER_MAGIC:
                    return True
        except OSError:
            continue
    return False


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def write_tilefs(dirpath: str, zoom: int, coarse_zoom: int,
                 pairs) -> str:
    """Write one zoom's tilefs file; returns the final path.

    ``pairs`` is an iterable of ``(user, timespan, codes, values)``
    with codes int64 and values float64 in the caller's row order; the
    writer applies the same stable argsort-by-code that ``Level`` does,
    so the mmap reader's views are bit-identical to the heap index
    (duplicates keep their relative order, vmax is stamped in the
    footer so serving never touches a data page to learn it).
    """
    os.makedirs(dirpath, exist_ok=True)
    final = tilefs_path(dirpath, zoom)
    tmp = final + ".tmp"
    segments = []
    for user, timespan, codes, values in pairs:
        codes = np.ascontiguousarray(codes, np.int64)
        values = np.ascontiguousarray(values, np.float64)
        order = np.argsort(codes, kind="stable")
        segments.append((str(user), str(timespan),
                         codes[order], values[order]))

    def _publish():
        index = []
        with open(tmp, "wb") as f:
            f.write(b"\0" * HEADER_SIZE)  # placeholder; rewritten below
            off = HEADER_SIZE
            for user, timespan, codes, values in segments:
                codes_off = _pad(off)
                f.write(b"\0" * (codes_off - off))
                buf = codes.tobytes()
                f.write(buf)
                codes_crc = zlib.crc32(buf)
                off = codes_off + len(buf)
                values_off = _pad(off)
                f.write(b"\0" * (values_off - off))
                buf = values.tobytes()
                f.write(buf)
                off = values_off + len(buf)
                index.append({
                    "user": user, "timespan": timespan,
                    "n": int(len(codes)),
                    "codes_off": codes_off, "values_off": values_off,
                    "vmax": float(values.max()) if len(values) else 0.0,
                    "codes_crc": codes_crc,
                    "values_crc": zlib.crc32(buf),
                })
            footer = json.dumps({
                "schema": SCHEMA, "zoom": int(zoom),
                "coarse_zoom": int(coarse_zoom), "pairs": index,
            }, sort_keys=True).encode()
            footer_off = off
            f.write(footer)
            f.write(struct.pack(_TRAILER_FMT, footer_off, len(footer),
                                zlib.crc32(footer), TRAILER_MAGIC))
            head = struct.pack(_HEADER_FMT, MAGIC, VERSION, ENDIAN_MARK,
                               int(zoom), int(coarse_zoom))
            head += struct.pack("=I", zlib.crc32(head))
            f.seek(0)
            f.write(head.ljust(HEADER_SIZE, b"\0"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    faults.retry_call(_publish, site="sink.write", key="tilefs")
    return final


class TilefsReader:
    """One open, validated tilefs file: mmap + zero-copy column views.

    Construction checks everything that is cheap (magic, version,
    endianness, header/footer crcs, segment bounds) and nothing that is
    not (payload crcs — that is :func:`verify_tilefs`'s job), so an
    open faults in no data pages. The mmap stays alive as long as any
    returned view does (``np.frombuffer`` holds the buffer).
    """

    def __init__(self, path: str):
        self.path = path
        faults.check("tilefs.read", key=os.path.basename(path))
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < HEADER_SIZE + TRAILER_SIZE:
                raise TilefsError(f"{path}: truncated ({size} bytes)")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        head = self._mm[:struct.calcsize(_HEADER_FMT)]
        magic, version, endian, zoom, coarse = struct.unpack(
            _HEADER_FMT, head)
        if magic != MAGIC:
            raise TilefsError(f"{path}: bad magic {magic!r}")
        if endian != ENDIAN_MARK:
            raise TilefsError(
                f"{path}: endianness mismatch (marker 0x{endian:08x}); "
                "written on a host with the other byte order")
        if version != VERSION:
            raise TilefsError(
                f"{path}: format version {version} (reader speaks "
                f"{VERSION} only)")
        (crc,) = struct.unpack_from("=I", self._mm,
                                    struct.calcsize(_HEADER_FMT))
        if crc != zlib.crc32(head):
            raise TilefsError(f"{path}: header crc mismatch")
        foot_off, foot_len, foot_crc, tmagic = struct.unpack_from(
            _TRAILER_FMT, self._mm, size - TRAILER_SIZE)
        if tmagic != TRAILER_MAGIC:
            raise TilefsError(f"{path}: trailer magic missing (torn "
                              "or truncated write)")
        if foot_off + foot_len > size - TRAILER_SIZE:
            raise TilefsError(f"{path}: footer out of bounds")
        footer = bytes(self._mm[foot_off:foot_off + foot_len])
        if zlib.crc32(footer) != foot_crc:
            raise TilefsError(f"{path}: footer crc mismatch")
        doc = json.loads(footer)
        if doc.get("schema") != SCHEMA:
            raise TilefsError(f"{path}: schema {doc.get('schema')!r}")
        if int(doc["zoom"]) != zoom or int(doc["coarse_zoom"]) != coarse:
            raise TilefsError(f"{path}: header/footer zoom disagree")
        self.zoom = zoom
        self.coarse_zoom = coarse
        self.pairs = doc["pairs"]
        for seg in self.pairs:
            n = int(seg["n"])
            end = max(int(seg["codes_off"]) + 8 * n,
                      int(seg["values_off"]) + 8 * n)
            if end > foot_off:
                raise TilefsError(
                    f"{path}: segment for ({seg['user']!r}, "
                    f"{seg['timespan']!r}) out of bounds")

    def arrays(self, seg: dict):
        """Zero-copy (codes, values) views for one footer ``pairs``
        entry — no bytes are read until numpy touches them."""
        n = int(seg["n"])
        codes = np.frombuffer(self._mm, np.int64, n,
                              int(seg["codes_off"]))
        values = np.frombuffer(self._mm, np.float64, n,
                               int(seg["values_off"]))
        return codes, values


def open_tilefs(path: str) -> TilefsReader:
    """Open + validate; raises :class:`TilefsError` on anything that
    must not be served (the caller owns the heap fallback)."""
    try:
        return TilefsReader(path)
    except (OSError, struct.error, json.JSONDecodeError,
            KeyError, UnicodeDecodeError) as exc:
        raise TilefsError(f"{path}: unreadable ({exc!r})") from exc


def verify_tilefs(path: str) -> str | None:
    """Deep check for the recovery sweep: everything the reader checks
    PLUS the per-segment payload crcs (this faults in every page, so it
    runs offline, never on the serve path). Returns None when intact,
    else a one-line reason."""
    try:
        r = TilefsReader(path)
    except Exception as exc:
        return f"{type(exc).__name__}: {exc}"
    try:
        for seg in r.pairs:
            codes, values = r.arrays(seg)
            if zlib.crc32(codes.tobytes()) != int(seg["codes_crc"]):
                return (f"codes crc mismatch for ({seg['user']!r}, "
                        f"{seg['timespan']!r})")
            if zlib.crc32(values.tobytes()) != int(seg["values_crc"]):
                return (f"values crc mismatch for ({seg['user']!r}, "
                        f"{seg['timespan']!r})")
    except OSError as exc:
        return f"unreadable payload: {exc}"
    return None


def write_tilefs_from_loaded(dirpath: str, levels: dict) -> list[str]:
    """Write tilefs mirrors for loaded-column levels ({zoom: cols} with
    ``user``/``timespan`` string columns — ``LevelArraysSink.load``'s
    shape). The per-pair split and Morton encoding here must match
    ``TileStore._build_from_levels`` exactly; the shared writer-side
    sort does the rest. Returns the written paths."""
    from heatmap_tpu_torch.tilemath.morton import morton_encode_np

    written = []
    for zoom in sorted(levels):
        cols = levels[zoom]
        users = np.asarray(cols["user"], str)
        tss = np.asarray(cols["timespan"], str)
        codes = morton_encode_np(
            np.asarray(cols["row"], np.int64),
            np.asarray(cols["col"], np.int64))
        values = np.asarray(cols["value"], np.float64)
        pair_key = np.char.add(np.char.add(users, "|"), tss)
        pairs = []
        for pk in np.unique(pair_key):
            sel = pair_key == pk
            user, _, ts = str(pk).partition("|")
            pairs.append((user, ts, codes[sel], values[sel]))
        written.append(write_tilefs(dirpath, int(zoom),
                                    int(cols["coarse_zoom"]), pairs))
    return written
