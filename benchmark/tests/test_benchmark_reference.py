"""The plain reference agrees with the port at small sizes on the CPU."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import batch as ref_batch
from benchmark.reference import raster as ref_raster
from benchmark.reference import tiles as ref_tiles

MIX = {"center": [47.6, -122.3], "spread": [0.5, 0.7],
       "hot_spread": [0.02, 0.03], "hot_share": 0.25}


def test_rows_cols_equal_the_port_at_every_zoom():
    from heatmap_tpu_torch.tilemath import mercator

    lat, lon = generate.host_points(50_000, MIX, 3, "t", "cpu")
    # Points on the edges of rows, where vector and scalar math part.
    edges = np.array([mercator.latitude_from_row(torch.tensor(r, dtype=torch.float64), 21).item()
                      for r in range(700_000, 700_050)])
    lat = np.concatenate([lat, edges, [91.0, -91.0, np.nan]])
    lon = np.concatenate([lon, np.full(len(edges) + 3, -122.0)])
    for zoom in (10, 15, 21):
        r, c, ok = ref_tiles.rows_cols(lat, lon, zoom)
        pr, pc, pok = mercator.project_points(torch.as_tensor(lat),
                                              torch.as_tensor(lon), zoom)
        assert np.array_equal(ok, pok.numpy())
        assert np.array_equal(r[ok], pr.numpy()[ok])
        assert np.array_equal(c[ok], pc.numpy()[ok])


def test_window_equals_the_port():
    from heatmap_tpu_torch.ops.histogram import window_from_bounds

    for box, z, a, p in [(((39.4333, 41.05), (115.4167, 117.5)), 16, 12, 256),
                         (((44, 51), (-127, -117)), 15, 12, 256),
                         (((46, 49), (-124, -120)), 10, 4, 16),
                         (((39.5, 40.3), (116.0, 116.9)), 13, 3, 64)]:
        w = window_from_bounds(box[0], box[1], z, align_levels=a,
                               pad_multiple=p)
        assert ref_tiles.window(box[0], box[1], z, a, p) == (
            w.row0, w.col0, w.height, w.width)


def test_pyramid_equals_the_port_step():
    from heatmap_tpu_torch import bench
    from heatmap_tpu_torch.ops.histogram import window_from_bounds

    lat, lon = generate.mixture_points(100_000, MIX, 4, "p", "cpu")
    w = window_from_bounds((46, 49), (-124, -120), 12, align_levels=6,
                           pad_multiple=64)
    _, pyr = bench.step(lat, lon, w, 12, "auto", proj_dtype=torch.float64)
    want = ref_raster.pyramid(ref_raster.bin_window(
        lat.numpy(), lon.numpy(), 12, (w.row0, w.col0, w.height, w.width)), 12)
    assert len(pyr) == len(want)
    for g, x in zip(pyr, want):
        assert np.array_equal(g.numpy(), x)


def test_job_blobs_equal_the_port():
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig, run_job

    cfg = {"points": {"center": [39.9, 116.4], "spread": [0.12, 0.16],
                      "hot_spread": [0.01, 0.015], "hot_share": 0.25},
           "background_share": 0.05,
           "users": {"count": 40, "zipf_exponent": 1.0, "excluded_every": 8,
                     "excluded_offset": 3, "route_every": 8,
                     "route_offset": 5}}
    table = generate.gps_table(30_000, cfg, 8, "t", "cpu")
    for detail, lowest in ((21, 5), (14, 4)):
        got = run_job(generate.TableSource(table),
                      config=BatchJobConfig(detail_zoom=detail,
                                            min_detail_zoom=lowest),
                      max_points_in_flight=0, device="cpu")
        job = {"detail_zoom": detail, "levels": detail - lowest,
               "result_delta": 5, "timespan": "alltime"}
        assert ref_batch.job_blobs(table, job) == got


def test_user_ids_and_rows_per_user():
    users = {"count": 182, "zipf_exponent": 1.0, "excluded_every": 16,
             "excluded_offset": 7, "route_every": 16, "route_offset": 11}
    ids = generate.user_ids(users)
    assert len(set(ids)) == 182
    assert sum(i.startswith("x-") for i in ids) == 11
    assert sum(i.startswith("rt-") for i in ids) == 11
    counts = generate.points_per_user(996_147, users)
    assert counts.sum() == 996_147 and counts.min() >= 1
    assert list(counts) == sorted(counts, reverse=True)
