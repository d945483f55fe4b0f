"""Device ms per traced step of the work launched inside the program's
``project.recheck`` span: the float64 row-edge recheck (its margin,
near-mask, ``nonzero`` and sync, the host's rows and their write-back)
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx.trace, "project.recheck",
                           ctx.counters.get("units"))
