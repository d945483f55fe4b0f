"""Host-side ingest sources and egress sinks of the port."""

from heatmap_tpu_torch.io.sinks import (
    BlobSink,
    JSONLBlobSink,
    MemorySink,
    open_sink,
)
from heatmap_tpu_torch.io.sources import (
    CSVSource,
    JSONLSource,
    Source,
    SyntheticSource,
    open_source,
)

__all__ = [
    "BlobSink", "CSVSource", "JSONLBlobSink", "JSONLSource", "MemorySink",
    "Source", "SyntheticSource", "open_sink", "open_source",
]
