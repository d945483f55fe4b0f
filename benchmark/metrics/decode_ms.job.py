"""Host ms per traced job inside the program's ``cascade.decode`` span: the
levels' copy to the host and their decode (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "cascade.decode",
                         ctx.counters.get("units"))
