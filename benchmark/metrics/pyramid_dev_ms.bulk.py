"""Device ms per traced step of the work launched inside the program's
``pyramid.coarsen`` span: the dense pyramid's 2x2 sums
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx.trace, "pyramid.coarsen",
                           ctx.counters.get("units"))
