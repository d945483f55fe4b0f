"""Disk cache tier: rendered tile bytes between the heap LRU and render.

The port's copy of heatmap_tpu/tilefs/diskcache.py: the same entry
format and key hashing, so either package reads the other's entries.

Sits under :class:`heatmap_tpu_torch.serve.cache.TileCache`: on a heap miss
the flight leader consults this directory before rendering, and
write-throughs after — so the single-flight guarantee the heap cache
already provides covers the disk fill too (one render AND one disk
write per key storm-wide).

Keys carry the exact invalidation epochs the serve tier already stamps
(cache key tuple + store generation + delta epoch; synopsis keys embed
the synopsis epoch in the tuple), hashed into a two-level fanout
directory. Entries are self-verifying::

    magic TFSC1 | type u8 (0=bytes, 1=utf-8 str) | length u64 |
    crc32(payload) u32 | payload

A torn or corrupt entry (crash mid-write, bit rot) fails the
length/crc check and is treated as a miss — unlinked and re-rendered,
never served. Writes stage to ``.tmp-*`` + ``os.replace`` under the
``diskcache.write`` fault site (retries=0: a failed fill is just a
skipped optimization, the tile was already rendered). ``sweep()`` runs
at attach time and removes orphan tmps and torn entries left by a
crash; ``_prune`` keeps the directory under ``max_bytes`` by evicting
oldest-access first (mtime is touched on every hit).
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
import zlib

from heatmap_tpu_torch import faults, obs

_registry = obs.get_registry()
DISK_CACHE_HITS = _registry.counter(
    "disk_cache_hits_total", "Tile renders avoided by the disk tier")
DISK_CACHE_MISSES = _registry.counter(
    "disk_cache_misses_total", "Disk-tier lookups that fell through "
    "to a render")
DISK_CACHE_TORN = _registry.counter(
    "disk_cache_torn_total", "Entries that failed the length/crc check "
    "and were treated as misses")
DISK_CACHE_EVICTIONS = _registry.counter(
    "disk_cache_evictions_total", "Entries pruned to stay under the "
    "byte cap")
DISK_CACHE_BYTES = _registry.gauge(
    "disk_cache_bytes", "Bytes currently held by the disk tier")

_MAGIC = b"TFSC1"
_HEAD_FMT = "=5sBQI"
_HEAD_SIZE = struct.calcsize(_HEAD_FMT)


class DiskTileCache:
    """Size-capped directory of rendered tile payloads.

    ``get``/``put`` take the full invalidation key (any repr-able
    tuple); entries from superseded epochs are never read again and
    age out through the LRU prune rather than via explicit
    invalidation — epoch-in-key makes staleness structurally
    impossible, exactly like the heap cache's generation check.
    """

    def __init__(self, root: str, max_bytes: int = 1 << 30):
        self.root = root
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        self.sweep()

    # -- key → path --------------------------------------------------------

    def _path(self, key) -> str:
        digest = hashlib.blake2b(repr(key).encode(),
                                 digest_size=16).hexdigest()
        return os.path.join(self.root, digest[:2], digest)

    # -- read path ---------------------------------------------------------

    def get(self, key):
        """Payload for ``key`` or None; torn entries count as misses
        and are unlinked so the re-render's write-through heals them."""
        path = self._path(key)
        counting = obs.metrics_enabled()
        try:
            with open(path, "rb") as f:
                head = f.read(_HEAD_SIZE)
                if len(head) < _HEAD_SIZE:
                    raise ValueError("short header")
                magic, kind, length, crc = struct.unpack(_HEAD_FMT, head)
                if magic != _MAGIC:
                    raise ValueError("bad magic")
                payload = f.read(length + 1)
                if len(payload) != length:
                    raise ValueError("short payload")
                if zlib.crc32(payload) != crc:
                    raise ValueError("crc mismatch")
        except FileNotFoundError:
            if counting:
                DISK_CACHE_MISSES.inc()
            return None
        except (OSError, ValueError):
            # Torn mid-write or corrupted on disk: a miss, never an
            # error — unlink so the directory doesn't accumulate junk.
            try:
                os.unlink(path)
            except OSError:
                pass
            if counting:
                DISK_CACHE_TORN.inc()
                DISK_CACHE_MISSES.inc()
            return None
        try:
            os.utime(path)  # LRU recency signal for _prune
        except OSError:
            pass
        if counting:
            DISK_CACHE_HITS.inc()
        return payload.decode() if kind == 1 else payload

    # -- write path --------------------------------------------------------

    def put(self, key, value) -> bool:
        """Write-through after a render. Failures (full disk, injected
        ``diskcache.write`` fault) skip the fill and return False — the
        caller already has the rendered bytes in hand."""
        payload = value.encode() if isinstance(value, str) else bytes(value)
        kind = 1 if isinstance(value, str) else 0
        path = self._path(key)
        tmp = os.path.join(os.path.dirname(path),
                           f".tmp-{os.path.basename(path)}")
        try:
            faults.check("diskcache.write", key=os.path.basename(path))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(struct.pack(_HEAD_FMT, _MAGIC, kind,
                                    len(payload), zlib.crc32(payload)))
                f.write(payload)
            os.replace(tmp, path)
        except (OSError, faults.InjectedFault):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self._prune()
        return True

    # -- maintenance -------------------------------------------------------

    def _entries(self):
        """[(mtime, size, path)] for every published entry."""
        out = []
        for d in os.listdir(self.root):
            sub = os.path.join(self.root, d)
            if not os.path.isdir(sub):
                continue
            for name in os.listdir(sub):
                full = os.path.join(sub, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                out.append((st.st_mtime, st.st_size, full))
        return out

    def _prune(self):
        """Evict oldest-access entries until under ``max_bytes``."""
        with self._lock:
            entries = self._entries()
            total = sum(size for _, size, _ in entries)
            if obs.metrics_enabled():
                DISK_CACHE_BYTES.set(total)
            if total <= self.max_bytes:
                return
            evicted = 0
            for _, size, full in sorted(entries):
                if total <= self.max_bytes:
                    break
                try:
                    os.unlink(full)
                except OSError:
                    continue
                total -= size
                evicted += 1
            if evicted and obs.metrics_enabled():
                DISK_CACHE_EVICTIONS.inc(evicted)
                DISK_CACHE_BYTES.set(total)

    def sweep(self) -> int:
        """Crash recovery: drop orphan ``.tmp-*`` stagings and torn
        entries so a restarted server never trips on them mid-serve.
        Returns the number of files removed."""
        removed = 0
        for d in sorted(os.listdir(self.root)):
            sub = os.path.join(self.root, d)
            if not os.path.isdir(sub):
                continue
            for name in sorted(os.listdir(sub)):
                full = os.path.join(sub, name)
                doomed = name.startswith(".tmp-")
                if not doomed:
                    try:
                        with open(full, "rb") as f:
                            head = f.read(_HEAD_SIZE)
                            magic, _, length, crc = struct.unpack(
                                _HEAD_FMT, head)
                            payload = f.read(length + 1)
                        doomed = (magic != _MAGIC
                                  or len(payload) != length
                                  or zlib.crc32(payload) != crc)
                    except (OSError, struct.error):
                        doomed = True
                if doomed:
                    try:
                        os.unlink(full)
                        removed += 1
                    except OSError:
                        pass
        return removed

    def stats(self) -> dict:
        entries = self._entries()
        return {"root": self.root, "entries": len(entries),
                "bytes": int(sum(s for _, s, _ in entries)),
                "max_bytes": self.max_bytes}
