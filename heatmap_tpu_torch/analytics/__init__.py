"""Integral-histogram pyramids and the range-query engine.

The port's copy of heatmap_tpu/analytics (numpy only): integral
artifacts that compaction writes beside the merged base (arxiv
1711.01919; docs/analytics.md), their read side, and the ``/query``
evaluators (``query.py``), with ``integral2d_torch``, the device twin
of the JAX package's jit'd scan.
"""

from heatmap_tpu_torch.analytics.integral import (  # noqa: F401
    DEFAULT_MAX_Z, HARD_MAX_Z, SCHEMA, IntegralPair, build_pair,
    grid_from_sat, integral2d_np, integral2d_torch, integral_path,
    load_integrals, merge_shard_sats, verify_integral, write_integrals,
)
from heatmap_tpu_torch.analytics.query import (  # noqa: F401
    VALID_OPS, parse_bbox, quantile, quantile_rows, range_sum,
    range_sum_rows, top_k_hotspots, top_k_rows, validate_op,
)
