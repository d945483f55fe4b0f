"""Each cell's control flow on the CPU at a small size: set-up, the
window, the traced run, the check and the metrics."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests.conftest import tiny

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, trace):
    cell = tiny(name)
    result, checks = harness.run_cell(cell, 2**31 + 11, 0.3, trace,
                                      torch.device("cpu"),
                                      time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    want = cell.per_layer if trace else cell.end_to_end
    got = set(result["metrics"])
    if trace:
        assert "busy_s" in result["device"] and "breakdown" in result
        # On the CPU only the readers of program spans and host clocks
        # find something; the device readers return nothing.
        assert got <= {m["name"] for m in want}
        assert result["device"]["busy_s"] == 0.0
    else:
        assert got == {m["name"] for m in want}
        assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    """Two drivers of one seed make the same inputs; another seed moves
    the points and keeps every size."""
    cell = tiny(name)
    made = []
    for seed in (5, 5, 6):
        d = spec.driver_class(cell)(cell, seed, torch.device("cpu"))
        d.setup()
        if hasattr(d, "inputs"):
            made.append([x.numpy().copy() for pair in d.inputs for x in pair])
        else:
            made.append([t["latitude"].copy() for t in d.tables]
                        + [sorted(t["user_id"]) for t in d.tables])
    import numpy as np

    for a, b in zip(made[0], made[1]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert any(not np.array_equal(np.asarray(a), np.asarray(c))
               for a, c in zip(made[0], made[2]))
    assert [np.shape(a) for a in made[0]] == [np.shape(c) for c in made[2]]
