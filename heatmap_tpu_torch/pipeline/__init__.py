"""The batch job: ingest -> group -> project -> cascade -> blobs.

- ``groups``   — user-id routing rules (reference heatmap.py:64-70).
- ``timespan`` — timespan labels (reference heatmap.py:38-52).
- ``cascade``  — the zoom cascade and blob egress.
- ``feeder``   — the double-buffered host->device feeder of chunked jobs
  and of the ingest loop's micro-batches.
- ``bucketing`` — bucketed padding of the cascade's emissions.
- ``batch``    — orchestration equivalent to the reference batchMain.
"""

from heatmap_tpu_torch.pipeline.batch import (
    BatchJobConfig,
    load_columns,
    run_batch,
    run_job,
    run_job_fast,
    run_job_resumable,
)
from heatmap_tpu_torch.pipeline.cascade import (
    CascadeConfig,
    build_cascade,
    run_cascade,
)
from heatmap_tpu_torch.pipeline.groups import ALL_GROUP, UserVocab, route_user
from heatmap_tpu_torch.pipeline.timespan import timespan_label

__all__ = [
    "ALL_GROUP", "BatchJobConfig", "CascadeConfig", "UserVocab",
    "build_cascade", "load_columns", "route_user", "run_batch",
    "run_cascade", "run_job", "run_job_fast", "run_job_resumable",
    "timespan_label",
]
