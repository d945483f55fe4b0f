"""Host-side ingest sources (synthetic, CSV, JSONL, Parquet, HMPB,
Cassandra token ranges, CosmosDB partition ranges), egress sinks
(memory, JSONL, directory, Cassandra, per-level arrays), the shard merge
(``io.merge``) and the PNG tile writer of the port (reference
get_rows/write_heatmap_dataframes, heatmap.py:131-150)."""

from heatmap_tpu_torch.io.hmpb import (
    HMPBDirSource,
    HMPBSource,
    convert_to_hmpb,
    write_hmpb,
)
from heatmap_tpu_torch.io.merge import merge_blob_files, merge_level_dirs
from heatmap_tpu_torch.io.png import colorize, png_bytes, raster_to_png
from heatmap_tpu_torch.io.sinks import (
    BlobSink,
    CassandraBlobSink,
    DirectoryBlobSink,
    JSONLBlobSink,
    LevelArraysSink,
    MemorySink,
    PNGTileSink,
    SinkConfigError,
    open_sink,
    validate_sink_spec,
)
from heatmap_tpu_torch.io.sources import (
    COLUMNS,
    TOKEN_MAX,
    TOKEN_MIN,
    CassandraConfig,
    CassandraSource,
    ConfigError,
    CosmosDBSource,
    CSVSource,
    JSONLSource,
    ParquetSource,
    Source,
    SyntheticSource,
    open_source,
    token_ranges,
)

__all__ = [
    "BlobSink", "COLUMNS", "CSVSource", "CassandraBlobSink",
    "CassandraConfig", "CassandraSource", "ConfigError", "CosmosDBSource",
    "DirectoryBlobSink", "HMPBDirSource", "HMPBSource", "JSONLBlobSink",
    "JSONLSource", "LevelArraysSink", "MemorySink", "PNGTileSink",
    "ParquetSource", "SinkConfigError", "Source", "SyntheticSource",
    "TOKEN_MAX", "TOKEN_MIN", "colorize", "convert_to_hmpb",
    "merge_blob_files", "merge_level_dirs", "open_sink", "open_source",
    "png_bytes", "raster_to_png", "token_ranges", "validate_sink_spec",
    "write_hmpb",
]
