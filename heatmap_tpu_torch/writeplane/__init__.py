"""Partitioned multi-writer write plane (the port's copy of
heatmap_tpu/writeplane; numpy and the delta store, the cascade on the
card).

Shards the delta journal and delta store by planned Morton ranges so N
ingest pumps append, apply, and compact independently, unified for
readers by an epoch-numbered manifest whose flip is the only
cross-writer coordination (ROADMAP "production write scale"). See
plane.py for the correctness model (byte identity to a single writer,
two-layer exactly-once), manifest.py for the epoch/flip discipline,
pumps.py for the thread drivers, recover.py for the plane-level sweep,
and docs/write-plane.md for the operator view.
"""

from heatmap_tpu_torch.writeplane.manifest import (ledger_dir,
                                                   load_snapshot,
                                                   overlay_dirs,
                                                   read_manifest,
                                                   read_pointer, range_root,
                                                   write_snapshot)
from heatmap_tpu_torch.writeplane.plane import (PlaneAppend, PlaneConfig,
                                                WritePlane, refresh_serving)
from heatmap_tpu_torch.writeplane.pumps import (PlanePumps, PlaneStats,
                                                PumpStats, run_plane_ingest)
from heatmap_tpu_torch.writeplane.recover import sweep_plane

__all__ = [
    "PlaneAppend", "PlaneConfig", "PlanePumps", "PlaneStats", "PumpStats",
    "WritePlane", "ledger_dir", "load_snapshot", "overlay_dirs",
    "read_manifest", "read_pointer", "range_root", "refresh_serving",
    "run_plane_ingest", "sweep_plane", "write_snapshot",
]
