"""Share of its HBM roofline that the float64 projection kernel
(``csrc/project_mercator.cu``) reaches in the traced window: the least
bytes of a step's projection (benchmark/roofline.py) over 3.35 TB/s,
against the profiler's device time of its calls, one a step, whose
launches are counted by ``project_points.fused_launches``."""

from benchmark import roofline


def read(ctx):
    return roofline.traced_share(
        ctx, "project_mercator", "project_launches",
        roofline.project_mercator_bytes(ctx.counters["points_per_unit"]))
