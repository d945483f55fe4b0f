"""One run of one cell: set-up, the measured (or traced) window, the
check against the reference, and the metrics, as one result line.

The CLI (``benchmark/run.py``) refuses to run without the cards the cell
asks for; the tests call :func:`run_cell` on the CPU at small sizes.
"""

from __future__ import annotations

import json
import random
import statistics
import sys
import time

from benchmark import spec as spec_mod
from benchmark import trace as trace_mod

#: Top-level module names that no run may have loaded: JAX and the JAX
#: package. Compared whole: ``heatmap_tpu_torch`` is not ``heatmap_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "heatmap_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Keeper:
    """The answers kept for the check: the last unit's, and one earlier
    unit's drawn from the seed (a reservoir of one)."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.seen = 0
        self.last = None
        self.sample = None

    def add(self, index: int, answer) -> None:
        if self.last is not None:
            self.seen += 1
            if self.rng.random() * self.seen < 1.0:
                self.sample = self.last
        self.last = (index, answer)

    def kept(self) -> list:
        return [k for k in (self.sample, self.last) if k is not None]


class Context:
    """What a metric reader reads: the cell, the counters of the run and,
    in a traced run, its :class:`benchmark.trace.Trace`."""

    def __init__(self, cell, counters: dict, trace=None):
        self.cell = cell
        self.counters = counters
        self.trace = trace


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, after_check=None):
    """Run ``cell`` once; returns ``(result, checks)``.

    ``checks`` is a list of ``(name, value, limit)``: a run is correct
    when every value is at most its limit. ``after_check(driver)``, when
    given, is called once the check has run (the calibration runs the
    control there, on the same inputs).
    """
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
    driver = spec_mod.driver_class(cell)(cell, seed, device)
    driver.setup_parts["process to driver"] = time.perf_counter() - t_start
    driver.setup()
    _sync(device)
    counters = {"setup_s": time.perf_counter() - t_start}
    tr = None
    if not trace:
        unit_s = []
        w0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            driver.unit()
            b = time.perf_counter()
            unit_s.append(b - a)
            if b - w0 >= seconds:
                break
        counters["window_s"] = b - w0
        counters["unit_s"] = unit_s
        counters["units"] = len(unit_s)
    else:
        sink = {}
        before = driver.program_counters()
        first = driver.n_units
        with trace_mod.profiled(device, sink):
            for _ in range(int(cell.traffic["trace_units"])):
                driver.unit()
        after = driver.program_counters()
        driver.traced = (first, driver.n_units)
        counters["traced_counters"] = {k: after[k] - before[k] for k in after}
        counters["units"] = driver.n_units - first
        counters.update(driver.instrumented())
        tr = sink["trace"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    driver.setup_parts["check (after the window)"] = (
        time.perf_counter() - t_check)
    if after_check is not None:
        after_check(driver)
    counters.update(driver.counters)
    ctx = Context(cell, counters, tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec_mod.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": correct,
        "attempted": int(counters["units"]),
        "failed": int(driver.failed),
        "metrics": metrics,
        "device": dev_info,
    }
    if trace:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    print("set-up parts (s): " + json.dumps(driver.setup_parts),
          file=sys.stderr)
    if counters.get("unit_s"):
        u = sorted(counters["unit_s"])
        print("unit s (min, quartiles, max): " + json.dumps(
            [u[0], *statistics.quantiles(u, n=4), u[-1]]
            if len(u) > 1 else u), file=sys.stderr)
    return result, checks
