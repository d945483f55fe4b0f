"""Host ms per traced job inside the program's ``ingest.vocab`` span: the
user vocabulary's group ids (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "ingest.vocab",
                         ctx.counters.get("units"))
