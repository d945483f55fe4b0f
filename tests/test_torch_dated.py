"""A dated job whose keys pass 60 bits, on the CPU: a seeded table of
dated trajectories (``benchmark/generate_dated.py``) over about 2,100
distinct days and the 182 users, at z21 with the alltime, year, month
and day timespans, needs 61-bit cascade keys. The port's ``run_job``
writes the plain reference's blobs (``benchmark/reference/timespans.py``)
byte for byte; its partitioned backend (the segment reduce's plain
version on the CPU) writes its scatter backend's; and both write the JAX
package's scatter blobs (the JAX package refuses such keys on its
partitioned backend, ROADMAP F9)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import generate_dated
from benchmark.generate import TableSource
from benchmark.reference import timespans as ref_timespans
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.pipeline import cascade as tcascade

CONFIG = pathlib.Path(__file__).resolve().parent.parent / (
    "benchmark/configs/geolife-timespans.json")
TIMESPANS = ("alltime", "year", "month", "day")
N_POINTS = 8000


@pytest.fixture(scope="module")
def table():
    cfg = json.loads(CONFIG.read_text())
    cfg["points_per_job"] = N_POINTS
    # 7,600 one-point trajectories over 2,133 days: about 2,070 of them.
    cfg["trajectories"] = N_POINTS
    cfg["walk"] = dict(cfg["walk"], last_day="2013-01-31")
    return generate_dated.dated_table(N_POINTS, cfg, 2**31 + 77, "test",
                                      torch.device("cpu"))


def _port(table, backend):
    blobs = tbatch.run_job(TableSource(table), device="cpu",
                           max_points_in_flight=0,
                           config=tbatch.BatchJobConfig(
                               timespans=TIMESPANS, cascade_backend=backend))
    return blobs, tcascade.build_cascade.key_bits


def test_table_spans_more_than_2000_days(table):
    kept = np.asarray(table["source"]) != "background"
    days = np.unique(table["timestamp"][kept] // generate_dated.DAY_MS)
    assert len(days) > 2000
    assert len(set(np.asarray(table["user_id"])[kept])) == 182


def test_dated_job_equals_reference_and_jax(table):
    job = {"detail_zoom": 21, "min_detail_zoom": 5, "result_delta": 5,
           "levels": 16, "timespans": list(TIMESPANS)}
    want = ref_timespans.job_blobs(table, job)
    scatter, bits = _port(table, "scatter")
    assert bits == 61
    assert scatter == want
    partitioned, bits = _port(table, "partitioned")
    assert bits == 61
    assert partitioned == want
    jax_blobs = jbatch.run_job(
        TableSource(table), max_points_in_flight=0,
        config=jbatch.BatchJobConfig(timespans=TIMESPANS,
                                     cascade_backend="scatter"))
    assert jax_blobs == want


def test_local_time_labels_differ(table):
    """The control of the benchmark's dated cell: labels from Beijing's
    local time (UTC+8) move points across day edges."""
    job = {"detail_zoom": 21, "min_detail_zoom": 5, "result_delta": 5,
           "levels": 16, "timespans": list(TIMESPANS)}
    utc = ref_timespans.job_blobs(table, job)
    local = ref_timespans.job_blobs(table, job, utc_offset_h=8)
    assert set(local) != set(utc)
