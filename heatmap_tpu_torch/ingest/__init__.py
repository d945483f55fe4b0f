"""Continuous-ingest subsystem: source -> journal -> cascade -> store.

The port's copy of heatmap_tpu/ingest: ``loop.py`` owns the
bounded-queue pump and the tick loop (``run_ingest`` is the entry;
``run_ticks`` is the pump ``streaming.run_stream`` also drives);
``metrics.py`` the watermark/lag/queue handles on the obs registry.
"""

from heatmap_tpu_torch.ingest.loop import (IngestConfig, IngestStats,
                                           TickContext, run_ingest,
                                           run_ticks)
from heatmap_tpu_torch.ingest.metrics import (INGEST_LAG_SECONDS,
                                              INGEST_POINTS,
                                              INGEST_QUEUE_DEPTH,
                                              INGEST_TICKS,
                                              INGEST_TICK_SECONDS,
                                              INGEST_WATERMARK,
                                              record_stream_tick)

__all__ = [
    "INGEST_LAG_SECONDS", "INGEST_POINTS", "INGEST_QUEUE_DEPTH",
    "INGEST_TICKS", "INGEST_TICK_SECONDS", "INGEST_WATERMARK",
    "IngestConfig", "IngestStats", "TickContext", "record_stream_tick",
    "run_ingest", "run_ticks",
]
