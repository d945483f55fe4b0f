"""Fixtures of the benchmark's tests: cells cut to sizes a CPU test holds.

Tests that need a card carry the ``card`` marker and skip inside the
test where ``torch.cuda.is_available()`` is false. On a card machine:

    python3 -m pytest benchmark/tests -q -p no:cacheprovider -m card
"""

from __future__ import annotations

import pytest
import torch

from benchmark import spec

#: A small window inside the GeoLife window's box, at z10 for runs at a
#: CPU test's size; the controls take it at the configuration's z16
#: (float32 tile math moves points at z16, not at z10).
TINY_WINDOW = {"lat": [39.5, 40.3], "lon": [116.0, 116.9], "zoom": 10,
               "align_levels": 4, "pad_multiple": 16}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips inside the test "
        "without one)")


def tiny(name: str, zoom: int = 10, points: int | None = None):
    """The cell ``name`` with its files read, cut to a CPU test's size."""
    c = spec.cell(name)
    if "window" in c.config:
        c.config["window"] = dict(TINY_WINDOW, zoom=zoom)
        c.config["levels"] = TINY_WINDOW["align_levels"]
    if "points_per_step" in c.config:
        c.config["points_per_step"] = points or 20_000
        c.traffic.update(distinct_inputs=2, split_steps=2)
    if "points_per_job" in c.config:
        c.config["points_per_job"] = points or 20_000
        c.traffic.update(distinct_tables=2, timed_units=1)
    c.traffic["trace_units"] = min(c.traffic["trace_units"], 3)
    return c


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on a card machine")
    return torch.device("cuda", 0)
