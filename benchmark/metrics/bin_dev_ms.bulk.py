"""Device ms per traced step of the work launched inside the program's
``bin.window`` span: the window binning (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx.trace, "bin.window",
                           ctx.counters.get("units"))
