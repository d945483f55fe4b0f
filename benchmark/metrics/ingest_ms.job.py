"""Median ms per job of the program's ``ingest`` stage (``StageTimer``,
fenced by synchronisation): reading the source's batches, the background
filter, the user vocabulary."""

from benchmark.metrics_support import stage_ms


def read(ctx):
    return stage_ms(ctx, ("ingest",))
