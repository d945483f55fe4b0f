"""Host ms per traced job inside the program's ``cascade.emissions`` span:
the emissions of every group and timespan (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "cascade.emissions",
                         ctx.counters.get("units"))
