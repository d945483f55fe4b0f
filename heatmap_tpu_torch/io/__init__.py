"""Host-side ingest sources, egress sinks and the PNG tile writer of the
port."""

from heatmap_tpu_torch.io.sinks import (
    BlobSink,
    JSONLBlobSink,
    MemorySink,
    PNGTileSink,
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
    "PNGTileSink", "Source", "SyntheticSource", "open_sink", "open_source",
]
