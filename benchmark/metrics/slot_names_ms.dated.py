"""Host ms per traced job inside the program's ``egress.slot_names`` span:
the table of every slot's user and label (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "egress.slot_names",
                         ctx.counters.get("units"))
