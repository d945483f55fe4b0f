"""Fault injection for the batch job's resumable paths.

The port's copy of ``FaultInjector`` from heatmap_tpu/utils/recovery.py:
deterministic per-batch failures for recovery tests and chaos runs, as
count rules on a private fault plane at the ``shard.compute`` site.
(``run_shards``, deterministic shard re-execution, waits for the port's
``parallel/`` slice.)
"""

from __future__ import annotations

from heatmap_tpu_torch import faults


class FaultInjector:
    """Deterministically fail chosen shards N times (for tests/chaos).

    ``fail_counts``: {shard_index: times_to_fail}. Call ``check(i)``
    at the top of shard work; it raises until shard i's budget is
    spent, then lets the shard through — modeling a transient fault.

    Implemented as per-shard count rules on a private
    :class:`heatmap_tpu_torch.faults.FaultPlane` (the ``shard.compute`` site),
    so the legacy API and the chaos plane share one injection engine.
    """

    def __init__(self, fail_counts: dict):
        self._plane = faults.FaultPlane()
        for shard_index, times in fail_counts.items():
            if times > 0:
                self._plane.add_rule("shard.compute", key=shard_index,
                                     count=int(times))

    @property
    def injected(self) -> int:
        return self._plane.injected

    def check(self, shard_index):
        self._plane.check("shard.compute", key=shard_index)
