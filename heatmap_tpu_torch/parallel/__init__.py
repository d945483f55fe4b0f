"""Spatial partitioning for the port: the numpy Morton-range planner.

The port's copy of heatmap_tpu/parallel/partition.py, which the write
plane plans its ranges with. The rest of heatmap_tpu/parallel (meshes,
the sharded and GSPMD cascades, multihost and elastic runs) is not
ported yet (ROADMAP Queue 1 item 7).
"""

from heatmap_tpu_torch.parallel.partition import (  # noqa: F401
    PartitionPlan,
    plan_partition,
    route_emissions,
    split_range_median,
)
