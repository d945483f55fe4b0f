"""Median ms of the pyramid stage over the traced run's split steps: one
step run stage by stage between CUDA events (benchmark/split.py)."""

import statistics


def read(ctx):
    ms = ctx.counters.get("split_ms", {}).get("pyramid")
    return statistics.median(ms) if ms else None
