"""Drivers: how the units of a traffic mix (a step, a job) are
fed to the program, and how their answers are judged.

A traffic file names its driver; the driver reads its sizes and rates
from the traffic and configuration files. Every driver has the
interface of :class:`Driver`.
"""

from __future__ import annotations

import time

from benchmark.generate import derive_seed
from benchmark.harness import Keeper


class Driver:
    """``setup()`` makes the inputs and warms up; ``unit()`` runs one
    unit and returns once the card has finished it; ``instrumented()``
    runs the traced run's units under the program's own timers and
    returns their counters; ``release()`` frees the program's state
    after the window; ``check()`` returns ``[(name, value, limit)]`` and
    ``control()`` the same numbers with the reference, at the precision
    below the configuration's, in the program's place."""

    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.n_units = 0
        self.failed = 0
        self.traced = None
        self.counters = {}
        self.keeper = Keeper(derive_seed(seed, "keeper"))
        self.setup_parts = {}
        self._mark_t = time.perf_counter()

    def mark(self, part: str) -> None:
        """End the set-up part ``part`` (seconds, for the run's log)."""
        now = time.perf_counter()
        self.setup_parts[part] = now - self._mark_t
        self._mark_t = now

    def limit(self, name: str) -> float:
        return float(self.traffic["limits"][name])

    def program_counters(self) -> dict:
        return {}

    def instrumented(self) -> dict:
        return {}

    def release(self) -> None:
        pass

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
