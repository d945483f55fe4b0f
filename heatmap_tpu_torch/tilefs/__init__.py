"""Recognising the zero-copy tile store's files (``tilefs-z*.bin``).

The port's copy of ``sniff_tilefs`` from heatmap_tpu/tilefs/format.py,
so that compaction can tell a base that carries tilefs mirrors and
refuse it. Writing and reading the mirrors (``arrays-tilefs:``) waits
with ``serve/`` for ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import os
import struct

TRAILER_MAGIC = b"TILEFSIX"
HEADER_SIZE = 64
TRAILER_SIZE = struct.calcsize("=QII8s")


def sniff_tilefs(dirpath: str) -> bool:
    """True when ``dirpath`` holds at least one ``tilefs-z*.bin`` file
    with an intact trailer magic (one stat and one 8-byte read per
    candidate)."""
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return False
    for name in names:
        if not (name.startswith("tilefs-z") and name.endswith(".bin")):
            continue
        try:
            int(name[len("tilefs-z"):-len(".bin")])
            with open(os.path.join(dirpath, name), "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if size < HEADER_SIZE + TRAILER_SIZE:
                    continue
                f.seek(size - 8)
                if f.read(8) == TRAILER_MAGIC:
                    return True
        except (ValueError, OSError):
            continue
    return False
