"""tilefs: zero-copy serving storage (docs/tilefs.md).

The port's copy of heatmap_tpu/tilefs (numpy only): the same files, the
same bytes. Three pillars:

- :mod:`heatmap_tpu_torch.tilefs.format`    — the mmap'd columnar
  per-zoom file format (``tilefs-z*.bin``) and its reader/writer/
  verifier;
- :mod:`heatmap_tpu_torch.tilefs.diskcache` — the size-capped disk tier
  of rendered tile bytes between the heap LRU and on-demand render;
- :mod:`heatmap_tpu_torch.tilefs.prewarm`   — popularity-driven cache
  pre-warming from the ``http_request`` event log.

Nothing here touches torch or a device: a tile server keeps serving
beside a busy or dead card.
"""

from heatmap_tpu_torch.tilefs.diskcache import DiskTileCache
from heatmap_tpu_torch.tilefs.format import (SCHEMA, TilefsError,
                                             TilefsReader, list_tilefs,
                                             open_tilefs, sniff_tilefs,
                                             tilefs_path, verify_tilefs,
                                             write_tilefs,
                                             write_tilefs_from_loaded)
from heatmap_tpu_torch.tilefs.prewarm import (PrewarmConfig, build_plan,
                                              warm)

__all__ = [
    "SCHEMA", "TilefsError", "TilefsReader", "DiskTileCache",
    "PrewarmConfig", "build_plan", "list_tilefs", "open_tilefs",
    "sniff_tilefs", "tilefs_path", "verify_tilefs", "warm",
    "write_tilefs", "write_tilefs_from_loaded",
]
