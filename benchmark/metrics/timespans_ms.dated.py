"""Host ms per traced job inside the program's ``emissions.timespans``
span: the timespan labels of every row, for each timespan type
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "emissions.timespans",
                         ctx.counters.get("units"))
