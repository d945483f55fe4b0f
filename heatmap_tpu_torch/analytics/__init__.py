"""Integral-histogram pyramids (summed-area tables per coarse level).

The port's copy of the numpy half of heatmap_tpu/analytics: integral
artifacts that compaction writes beside the merged base (arxiv
1711.01919; docs/analytics.md). The range-query engine (``query.py``)
waits with ``serve/`` for ROADMAP Queue 1 item 6.
"""

from heatmap_tpu_torch.analytics.integral import (  # noqa: F401
    DEFAULT_MAX_Z, HARD_MAX_Z, SCHEMA, build_pair, integral2d_np,
    integral_path, verify_integral, write_integrals,
)
