"""Host ms per traced job inside the program's ``egress.blobs`` span: the
JSON blobs (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "egress.blobs",
                         ctx.counters.get("units"))
