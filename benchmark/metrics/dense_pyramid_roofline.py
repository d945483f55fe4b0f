"""Share of its HBM roofline that the dense pyramid kernel
(``csrc/dense_pyramid.cu``) reaches in the traced window: the least
bytes of a step's pyramid (benchmark/roofline.py) over 3.35 TB/s,
against the profiler's device time of its calls, one a step, whose
launches are counted by ``pyramid_from_raster.launches``."""

from benchmark import roofline


def read(ctx):
    c = ctx.counters
    h, w = c["window_shape"]
    return roofline.traced_share(
        ctx, "dense_pyramid", "pyramid_launches",
        roofline.dense_pyramid_bytes(h, w, c["pyramid_levels"]))
