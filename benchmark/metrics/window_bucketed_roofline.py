"""Share of its HBM roofline that the bucketed window kernel
(``csrc/window_bucketed.cu``) reaches in the traced window: the least
bytes of its calls (benchmark/roofline.py) over 3.35 TB/s, against the
profiler's device time of its calls: their kernels and the memsets
that zero their outputs (``Trace.op_time``)."""

from benchmark import roofline


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    calls = c.get("traced_counters", {}).get("bucketed_calls", 0)
    if tr is None or not calls:
        return None
    device_s, seen = tr.op_time(roofline.kernel_names("window_bucketed"))
    if seen != calls:
        return None
    per_call = roofline.window_bucketed_bytes(c["bucketed_points"],
                                              c["window_cells"])
    return roofline.share_pct(calls * per_call, device_s)
