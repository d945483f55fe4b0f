"""Helpers shared by the metric readers of ``metrics/``."""

import statistics


def stage_ms(ctx, stages):
    """Median over the timed jobs of the summed ms of ``stages`` in the
    program's ``StageTimer``, or None where a stage was not timed."""
    per = ctx.counters.get("stage_ms", {})
    if not all(per.get(s) for s in stages):
        return None
    jobs = zip(*(per[s] for s in stages))
    return statistics.median(sum(j) for j in jobs)
