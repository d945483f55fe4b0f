"""Every cell through the CLI on a card: a short window and a traced
run, each correct, with every metric it promises. On a card machine:

    python3 -m pytest benchmark/tests -q -p no:cacheprovider -m card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1], ids=["window", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    cell = spec.cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
    assert result["device"]["platform"] == "gpu"
    for m, v in result["metrics"].items():
        if m.endswith("_roofline"):
            assert 0 < v["value"] <= 100, (m, v)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
