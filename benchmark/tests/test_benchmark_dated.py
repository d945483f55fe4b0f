"""The checks of the dated and the arrays cells catch a broken timed path,
and their controls fail them.

As in ``test_benchmark_faults.py``: each fault is planted in the program
underneath a whole run on the CPU (the chip check skipped), and the run's
``correct`` must come out false: half of the batch left out, and an
answer altered where it is produced; in the dated cell also the labels
taken from Beijing's local time (UTC+8) instead of UTC. The controls,
the reference at float32 tile math in the program's place and, in the
dated cell, the reference with local-time labels, must read above every
limit that a sound run keeps.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import tiny

DATED = "geolife-timespans.dated"
ARRAYS = "geolife-batch.arrays"


def _run(cell, after_check=None):
    result, _ = harness.run_cell(cell, 987654321012, 0.2, False,
                                 torch.device("cpu"), time.perf_counter(),
                                 after_check=after_check)
    return result


@pytest.mark.parametrize("name", [DATED, ARRAYS])
def test_half_batch(name, monkeypatch):
    from heatmap_tpu_torch.pipeline import batch

    orig = batch.load_columns

    def half(b):
        cols = orig(b)
        n = len(cols["latitude"]) // 2
        return {k: v[:n] for k, v in cols.items()}

    monkeypatch.setattr(batch, "load_columns", half)
    assert not _run(tiny(name))["correct"]


def test_dated_answer_altered(monkeypatch):
    from heatmap_tpu_torch.pipeline import cascade

    orig = cascade.json_blobs_from_level_arrays

    def altered(levels):
        out = orig(levels)
        key = next(k for k in out if "|20" in k)
        out[key] = out[key].replace(".0", ".5", 1)
        return out

    monkeypatch.setattr(cascade, "json_blobs_from_level_arrays", altered)
    assert not _run(tiny(DATED))["correct"]


def test_arrays_answer_altered(monkeypatch):
    from heatmap_tpu_torch.pipeline import cascade

    orig = cascade.finalize_level_arrays

    def altered(*a, **k):
        out = orig(*a, **k)
        out[3]["value"][5] += 1
        return out

    monkeypatch.setattr(cascade, "finalize_level_arrays", altered)
    assert not _run(tiny(ARRAYS))["correct"]


def test_dated_local_time_labels(monkeypatch):
    from heatmap_tpu_torch.pipeline import timespan

    orig = timespan.TimespanVocab.label_ids

    def local(self, kind, timestamps):
        stamps = np.asarray(timestamps, np.int64) + 8 * 3_600_000
        return orig(self, kind, stamps)

    monkeypatch.setattr(timespan.TimespanVocab, "label_ids", local)
    assert not _run(tiny(DATED))["correct"]


@pytest.mark.parametrize("name,names", [
    (DATED, {"blobs_off", "blobs_off.local_time"}),
    (ARRAYS, {"levels_off"})])
def test_controls_fail_the_check(name, names):
    got = {}
    result = _run(tiny(name), after_check=lambda d: got.update(
        {n: (v, lim) for n, v, lim in d.control()}))
    assert result["correct"], result["checks"]
    assert set(got) == names
    assert all(v > lim for v, lim in got.values()), got
