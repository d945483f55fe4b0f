"""Device ms per traced step of the work launched inside the program's
``project.rows`` span: the float64 rows (``tan``, ``cos``, ``log``,
``floor``) (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx.trace, "project.rows",
                           ctx.counters.get("units"))
