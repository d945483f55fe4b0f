"""Host-side ingest sources (synthetic, CSV, JSONL, HMPB), egress sinks
(memory, JSONL, per-level arrays) and the PNG tile writer of the port."""

from heatmap_tpu_torch.io.sinks import (
    BlobSink,
    JSONLBlobSink,
    LevelArraysSink,
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
    "BlobSink", "CSVSource", "JSONLBlobSink", "JSONLSource",
    "LevelArraysSink", "MemorySink",
    "PNGTileSink", "Source", "SyntheticSource", "open_sink", "open_source",
]
