"""The check catches a broken timed path, and the control fails it.

Each fault is planted in the program underneath a whole run on the CPU
(the chip check skipped), and the run's ``correct`` must come out
false: half of the batch left out, and an answer altered where it is
produced. Neither cell carries state from one unit to the next, so
there is no step that could return its state unchanged; one chip, so
there is no exchange between chips to leave out. The control,
the reference at float32 tile math in the program's place, must fail
the check of every cell.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import tiny


def _run(cell, after_check=None):
    result, _ = harness.run_cell(cell, 987654321012, 0.2, False,
                                 torch.device("cpu"), time.perf_counter(),
                                 after_check=after_check)
    return result


def _halve_points(module, name, monkeypatch):
    orig = getattr(module, name)

    def half(lat, lon, *a, **k):
        n = len(lat) // 2
        return orig(lat[:n], lon[:n], *a, **k)

    monkeypatch.setattr(module, name, half)


def _bump_cell(module, name, monkeypatch):
    orig = getattr(module, name)

    def bumped(*a, **k):
        out = orig(*a, **k)
        out.view(-1)[7] += 1
        return out

    monkeypatch.setattr(module, name, bumped)


def test_bulk_half_batch(monkeypatch):
    from heatmap_tpu_torch import bench

    _halve_points(bench, "bin_points_window", monkeypatch)
    assert not _run(tiny("geolife-z16.bulk"))["correct"]


def test_bulk_answer_altered(monkeypatch):
    from heatmap_tpu_torch import bench

    _bump_cell(bench, "bin_points_window", monkeypatch)
    assert not _run(tiny("geolife-z16.bulk"))["correct"]


def test_job_half_batch(monkeypatch):
    from heatmap_tpu_torch.pipeline import batch

    orig = batch.load_columns

    def half(b):
        cols = orig(b)
        n = len(cols["latitude"]) // 2
        return {k: v[:n] for k, v in cols.items()}

    monkeypatch.setattr(batch, "load_columns", half)
    assert not _run(tiny("geolife-batch.job"))["correct"]


def test_job_answer_altered(monkeypatch):
    from heatmap_tpu_torch.pipeline import cascade

    orig = cascade.json_blobs_from_level_arrays

    def altered(levels):
        out = orig(levels)
        key = next(iter(out))
        out[key] = out[key].replace(".0", ".5", 1)
        return out

    monkeypatch.setattr(cascade, "json_blobs_from_level_arrays", altered)
    assert not _run(tiny("geolife-batch.job"))["correct"]


@pytest.mark.parametrize("name,points", [("geolife-z16.bulk", 200_000),
                                         ("geolife-batch.job", 20_000)])
def test_control_fails_the_check(name, points):
    """The reference at float32 tile math, in the program's place, reads
    above every limit that a sound run keeps (at z16: float32 moves
    points across tile edges; at z21 many)."""
    cell = tiny(name, zoom=16, points=points)
    got = {}
    result = _run(cell, after_check=lambda d: got.update(
        {n: (v, lim) for n, v, lim in d.control()}))
    assert result["correct"], result["checks"]
    assert got and all(v > lim for v, lim in got.values()), got
