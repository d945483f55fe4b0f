"""Tile math for the port: f64 Web-Mercator projection and Morton codes."""

from heatmap_tpu_torch.tilemath.morton import (  # noqa: F401
    morton_decode,
    morton_encode,
    morton_parent,
    morton_range_shards_np,
    split_boundary_codes_np,
)
