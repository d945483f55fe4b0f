"""Host-side ingest sources (synthetic, CSV, JSONL, Parquet, HMPB),
egress sinks (memory, JSONL, directory, per-level arrays), the shard
merge (``io.merge``) and the PNG tile writer of the port."""

from heatmap_tpu_torch.io.sinks import (
    BlobSink,
    DirectoryBlobSink,
    JSONLBlobSink,
    LevelArraysSink,
    MemorySink,
    PNGTileSink,
    open_sink,
)
from heatmap_tpu_torch.io.sources import (
    CSVSource,
    JSONLSource,
    ParquetSource,
    Source,
    SyntheticSource,
    open_source,
)

__all__ = [
    "BlobSink", "CSVSource", "DirectoryBlobSink", "JSONLBlobSink",
    "JSONLSource", "LevelArraysSink", "MemorySink", "PNGTileSink",
    "ParquetSource", "Source", "SyntheticSource", "open_sink", "open_source",
]
