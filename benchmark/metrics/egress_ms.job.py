"""Median ms per job of the program's ``decode`` and ``egress`` stages
(``StageTimer``): keys back to tiles, finalize, the JSON blobs."""

from benchmark.metrics_support import stage_ms


def read(ctx):
    return stage_ms(ctx, ("decode", "egress"))
