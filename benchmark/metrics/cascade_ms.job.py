"""Median ms per job of the program's ``sort`` and ``segment_reduce``
stages (``StageTimer``): the 16-level cascade on the card."""

from benchmark.metrics_support import stage_ms


def read(ctx):
    return stage_ms(ctx, ("sort", "segment_reduce"))
