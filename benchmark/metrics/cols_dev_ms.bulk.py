"""Device ms per traced step of the work launched inside the program's
``project.cols`` span: the columns, the validity mask, ``where``,
``clamp`` and the casts (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx.trace, "project.cols",
                           ctx.counters.get("units"))
