"""Continuous ingest: the tick pump (``loop.run_ticks``) that
``streaming.run_stream`` drives its micro-batches through."""

from heatmap_tpu_torch.ingest.loop import TickContext, run_ticks

__all__ = ["TickContext", "run_ticks"]
