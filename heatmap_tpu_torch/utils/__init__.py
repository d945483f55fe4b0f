"""Auxiliary runtime pieces of the batch job: host spans and throughput
(``trace``), atomic checkpoints with retention (``checkpoint``) and
fault injection for recovery tests (``recovery``)."""

from heatmap_tpu_torch.utils.checkpoint import (  # noqa: F401
    CheckpointManager,
    fsync_dir,
    load_checkpoint,
    publish_dir,
    save_checkpoint,
)
from heatmap_tpu_torch.utils.recovery import FaultInjector  # noqa: F401
from heatmap_tpu_torch.utils.trace import Tracer, get_tracer, span  # noqa: F401
