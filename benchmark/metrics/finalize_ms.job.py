"""Host ms per traced job inside the program's ``egress.finalize`` span:
the finalized level arrays (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "egress.finalize",
                         ctx.counters.get("units"))
