"""Host ms per traced job inside the program's ``cascade.project`` span:
the columns' upload and the float64 projection to Morton codes
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "cascade.project",
                         ctx.counters.get("units"))
