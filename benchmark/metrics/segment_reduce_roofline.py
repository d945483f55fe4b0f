"""Share of its HBM roofline that the segment reduce
(``csrc/segment_reduce.cu``) reaches in the traced jobs: per launch (one
per cascade level) the keys read once and the level's unique keys and
counts, as the reference finds them, written once, over 3.35 TB/s,
against the profiler's device time of its calls: their kernels
and memsets (``Trace.op_time``)."""

from benchmark import roofline


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    io = c.get("segment_io")
    launches = c.get("traced_counters", {}).get("segment_launches", 0)
    if tr is None or not io or launches != len(io):
        return None
    device_s, seen = tr.op_time(roofline.kernel_names("segment_reduce"))
    if seen != launches:
        return None
    return roofline.share_pct(
        sum(roofline.segment_reduce_bytes(n, u) for n, u in io), device_s)
