"""Scale soak checks: equivalences the unit suite cannot afford.

The port's twin of ``tools/soak.py``. Each check runs at ``--n``
points on ``--device`` and prints one JSON line (the JAX tool's keys);
the exit code is 1 if any failed:

- ``fast-vs-bounded``: ``run_job_fast`` against the chunked ``run_job``,
  byte-equal level arrays;
- ``mesh``: the sharded reduce-by-key over a mesh against one device's,
  on skewed keys;
- ``dp-job``: ``run_job_fast`` data-parallel over the mesh against one
  device, byte-equal level arrays (counts, weights, the prefix merge);
- ``resume``: a fault-injected crash and a resume equal to an
  uninterrupted run;
- ``streaming``: the row-sharded decayed stream replays bit-equal;
- ``weighted``: (a) a weighted job with every value 3 equals 3x the
  counted job; (b) ``bin_rowcol_window_partitioned`` with integer
  weights (the weighted bucketed kernel on a card) bit-equal to the
  scatter path at a z15 window of ``min(n, 2^20)`` points.

The mesh checks lay MESH_SHARDS shards on the device through the mesh
seam (``parallel.mesh._lay_shards``: on the CPU what
``force_cpu_devices`` sets, on a card n shards on the one card), where
the JAX tool takes its devices from XLA's virtual-device flag. ``--tpu``
is accepted and changes nothing: ``--device`` decides. The lines also go
to the record file with ``device`` and, on a card, ``gpu_name`` and
``power_limit_w``.

    python -m heatmap_tpu_torch.tools.soak [--n 2000000]
        [--checks fast-vs-bounded,...] [--device cuda|cpu]
        [--out build/torch_bench/soak.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from heatmap_tpu_torch.tools._common import (default_out, device_fields,
                                             synchronize, write_record)

CHECKS = ("fast-vs-bounded", "mesh", "dp-job", "resume", "streaming",
          "weighted")

#: Shards the mesh checks lay on the device (the JAX tool's 8 virtual
#: devices).
MESH_SHARDS = 8


def _synth_hmpb(path, n, n_users=300, seed=1, dated=False, weighted=False):
    from heatmap_tpu_torch.io.hmpb import write_hmpb

    rng = np.random.default_rng(seed)
    names = ["all"] + [f"user{i}" for i in range(n_users)] + ["route"]
    return write_hmpb(
        path,
        47.6 + rng.normal(0, 0.5, n),
        -122.3 + rng.normal(0, 0.7, n),
        rng.integers(1, len(names), n, dtype=np.int32),
        names,
        timestamp=rng.integers(1_500_000_000_000, 1_600_000_000_000, n)
        if dated else None,
        background=(rng.random(n) < 0.02).astype(np.uint8),
        # Integer-valued f64 weights: exact sums under any split.
        value=rng.integers(1, 12, n).astype(np.float64)
        if weighted else None,
    )


def _assert_levels_equal(a_dir, b_dir):
    """Whole-column byte equality of two level dirs -> (levels, rows)."""
    from heatmap_tpu_torch.io.sinks import LevelArraysSink

    la, lb = LevelArraysSink.load(a_dir), LevelArraysSink.load(b_dir)
    assert la.keys() == lb.keys(), (sorted(la), sorted(lb))
    rows = 0
    for z in la:
        for k in ("row", "col", "value", "user", "timespan",
                  "coarse_row", "coarse_col"):
            np.testing.assert_array_equal(la[z][k], lb[z][k])
        rows += len(la[z]["value"])
    return len(la), rows


def check_fast_vs_bounded(n, tmp, device):
    from heatmap_tpu_torch.io.hmpb import HMPBSource
    from heatmap_tpu_torch.io.sinks import LevelArraysSink
    from heatmap_tpu_torch.pipeline import (BatchJobConfig, run_job,
                                            run_job_fast)

    hmpb = _synth_hmpb(os.path.join(tmp, "p.hmpb"), n)
    # One device: data-parallel equality is dp-job's.
    cfg = BatchJobConfig(data_parallel=False)
    a = os.path.join(tmp, "a")
    b = os.path.join(tmp, "b")
    run_job_fast(HMPBSource(hmpb), LevelArraysSink(a), config=cfg,
                 device=device)
    run_job(HMPBSource(hmpb), LevelArraysSink(b), config=cfg,
            max_points_in_flight=max(n // 4, 1000), device=device)
    levels, rows = _assert_levels_equal(a, b)
    return {"levels": levels, "rows": rows}


def check_mesh(n, tmp, device):
    """The sharded aggregation over the mesh against one device's."""
    import torch

    from heatmap_tpu_torch.ops.sparse import aggregate_keys
    from heatmap_tpu_torch.parallel import make_mesh
    from heatmap_tpu_torch.parallel.mesh import local_devices
    from heatmap_tpu_torch.parallel.sharded import aggregate_keys_sharded

    ndev = len(local_devices(device))
    if ndev < 2:
        return {"skipped": "needs a multi-device mesh"}
    mesh = make_mesh(devices=local_devices(device))
    n = max(n - n % ndev, ndev)  # shardable length
    rng = np.random.default_rng(4)
    # Skewed keys: a hot head and a long tail.
    keys = torch.as_tensor(np.concatenate([
        rng.integers(0, 500, n // 2),
        rng.integers(0, n, n - n // 2),
    ]).astype(np.int64), device=device)
    want_k, want_s, want_n = aggregate_keys(keys, capacity=n)
    got_k, got_s, got_n = aggregate_keys_sharded(keys, capacity=n,
                                                 mesh=mesh)
    wn, gn = int(want_n), int(got_n)
    assert wn == gn, f"unique counts diverged: {wn} vs {gn}"
    np.testing.assert_array_equal(want_k[:wn].cpu().numpy(),
                                  got_k[:gn].cpu().numpy())
    np.testing.assert_array_equal(want_s[:wn].cpu().numpy(),
                                  got_s[:gn].cpu().numpy())
    return {"uniques": wn, "devices": ndev, "mesh": dict(mesh.shape)}


def check_dp_job(n, tmp, device):
    """The job data-parallel over the mesh against one device, at
    scale: byte-equal level arrays."""
    from heatmap_tpu_torch.io.hmpb import HMPBSource
    from heatmap_tpu_torch.io.sinks import LevelArraysSink
    from heatmap_tpu_torch.parallel.mesh import local_devices
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job_fast

    ndev = len(local_devices(device))
    if ndev < 2:
        return {"skipped": "needs a multi-device mesh"}
    n = min(n, 500_000)  # the JAX tool's bound

    def job(path, out, **kw):
        run_job_fast(HMPBSource(path), LevelArraysSink(out),
                     config=BatchJobConfig(**kw), device=device)

    hmpb = _synth_hmpb(os.path.join(tmp, "dp.hmpb"), n)
    a, b = os.path.join(tmp, "dp-a"), os.path.join(tmp, "dp-b")
    job(hmpb, a, data_parallel=True)
    job(hmpb, b, data_parallel=False)
    levels, rows = _assert_levels_equal(a, b)
    # Integer-valued f64 weights stay bit-exact through the merge.
    whmpb = _synth_hmpb(os.path.join(tmp, "dpw.hmpb"), n, weighted=True)
    wa, wb = os.path.join(tmp, "dpw-a"), os.path.join(tmp, "dpw-b")
    job(whmpb, wa, data_parallel=True, weighted=True)
    job(whmpb, wb, data_parallel=False, weighted=True)
    wlevels, wrows = _assert_levels_equal(wa, wb)
    # The coarse-prefix merge equals one device's arrays too.
    p = os.path.join(tmp, "dp-p")
    job(hmpb, p, data_parallel=True, dp_merge="prefix")
    _assert_levels_equal(p, b)
    return {"levels": levels, "rows": rows, "weighted_rows": wrows,
            "prefix_merge": "ok", "devices": ndev}


def check_resume(n, tmp, device):
    from heatmap_tpu_torch.io.hmpb import HMPBSource
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job_fast
    from heatmap_tpu_torch.utils.recovery import FaultInjector

    hmpb = _synth_hmpb(os.path.join(tmp, "r.hmpb"), n, dated=True)
    cfg = BatchJobConfig(timespans=("alltime", "day"), data_parallel=False)
    bs = max(n // 8, 1)  # at least 8 batches, so the mid fault fires
    n_batches = -(-n // bs)
    fail_at = n_batches // 2
    want = run_job_fast(HMPBSource(hmpb), config=cfg, batch_size=bs,
                        device=device)
    ck = os.path.join(tmp, "ck")
    try:
        run_job_fast(HMPBSource(hmpb), config=cfg, batch_size=bs,
                     checkpoint_dir=ck, checkpoint_every=2,
                     fault_injector=FaultInjector({fail_at: 1}),
                     device=device)
        raise AssertionError("expected the injected fault to fire")
    except RuntimeError:
        pass
    got = run_job_fast(HMPBSource(hmpb), config=cfg, batch_size=bs,
                       checkpoint_dir=ck, checkpoint_every=2,
                       device=device)
    assert want == got, f"resume diverged: {len(want)} vs {len(got)} blobs"
    return {"blobs": len(want)}


def check_streaming(n, tmp, device):
    from heatmap_tpu_torch.ops import window_from_bounds
    from heatmap_tpu_torch.parallel import make_mesh
    from heatmap_tpu_torch.parallel.mesh import local_devices
    from heatmap_tpu_torch.streaming import HeatmapStream, StreamConfig

    win = window_from_bounds((44.0, 51.0), (-127.0, -117.0), zoom=12,
                             align_levels=10, pad_multiple=256)
    devices = local_devices(device)
    mesh = make_mesh(devices=devices) if len(devices) > 1 else None
    batch = max(n // 50, 1000)

    def run():
        s = HeatmapStream(
            StreamConfig(window=win, half_life_s=30.0, pad_to=batch),
            mesh=mesh, device=device)
        rng = np.random.default_rng(0)
        t = 0.0
        for _ in range(50):
            t += 5.0
            s.update(47.6 + rng.normal(0, 0.5, batch),
                     -122.3 + rng.normal(0, 0.7, batch), t)
        return s.snapshot()

    r1, r2 = run(), run()
    np.testing.assert_array_equal(r1, r2)
    return {"batches": 50, "batch": batch, "mass": float(r1.sum()),
            "sharded": mesh is not None}


def check_weighted(n, tmp, device):
    """(a) Job linearity: every value 3 gives exactly 3x the counted
    blobs. (b) The weighted partitioned binning against the weighted
    scatter, bit-equal for integer weights at a z15 window."""
    import torch

    from heatmap_tpu_torch.ops import window_from_bounds
    from heatmap_tpu_torch.ops.histogram import bin_rowcol_window
    from heatmap_tpu_torch.ops.partitioned import (
        bin_rowcol_window_partitioned)
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job
    from heatmap_tpu_torch.tilemath import mercator

    rng = np.random.default_rng(9)
    n_job = min(n, 200_000)  # the string job path is host-bound
    users = (["all_is_reserved"] + [f"u{i}" for i in range(50)]
             + ["x-hidden", "rt-bus"])
    lat = 47.6 + rng.normal(0, 0.5, n_job)
    lon = -122.3 + rng.normal(0, 0.7, n_job)
    uid = rng.integers(0, len(users), n_job)

    class _Src:
        def __init__(self, with_values):
            self.with_values = with_values

        def batches(self, batch_size):
            for i in range(0, n_job, batch_size):
                sl = slice(i, i + batch_size)
                out = {
                    "latitude": lat[sl], "longitude": lon[sl],
                    "user_id": [users[j] for j in uid[sl]],
                    "source": [], "timestamp": [],
                }
                if self.with_values:
                    out["value"] = np.full(len(lat[sl]), 3.0)
                yield out

    cfg = BatchJobConfig(detail_zoom=14, min_detail_zoom=6,
                         data_parallel=False)
    counted = run_job(_Src(False), config=cfg, batch_size=1 << 16,
                      device=device)
    weighted = run_job(_Src(True),
                       config=dataclasses.replace(cfg, weighted=True),
                       batch_size=1 << 16, device=device)
    assert counted.keys() == weighted.keys()
    checked = 0
    for key, blob in counted.items():
        c = json.loads(blob)
        w = json.loads(weighted[key])
        assert c.keys() == w.keys(), key
        for tile, cnt in c.items():
            assert w[tile] == 3.0 * cnt, (key, tile, w[tile], cnt)
            checked += 1

    win = window_from_bounds((44.0, 51.0), (-127.0, -117.0), zoom=15,
                             align_levels=12, pad_multiple=256)
    m = min(n, 1 << 20)
    kl = torch.as_tensor((47.6 + rng.normal(0, 0.5, m)).astype(np.float32),
                         device=device)
    ko = torch.as_tensor((-122.3 + rng.normal(0, 0.7, m)).astype(
        np.float32), device=device)
    kw = torch.as_tensor(rng.integers(0, 16, m).astype(np.float32),
                         device=device)
    r, c, v = mercator.project_points(kl, ko, win.zoom, dtype=torch.float32)
    a = bin_rowcol_window(r, c, win, weights=kw, valid=v).cpu().numpy()
    b = bin_rowcol_window_partitioned(r, c, win, weights=kw,
                                      valid=v).cpu().numpy()
    np.testing.assert_array_equal(a, b)
    return {"blob_values_checked": checked, "kernel_points": m,
            "kernel_mass": float(a.sum())}


FNS = {"fast-vs-bounded": check_fast_vs_bounded,
       "mesh": check_mesh,
       "dp-job": check_dp_job,
       "resume": check_resume,
       "streaming": check_streaming,
       "weighted": check_weighted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="heatmap_tpu_torch.tools.soak")
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--checks", default=",".join(CHECKS))
    ap.add_argument("--tpu", action="store_true",
                    help="accepted for the JAX tool's command lines; "
                    "--device decides")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("soak"),
                    help="record file (default %(default)s)")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.parallel.mesh import _lay_shards

    device = resolve_device(args.device)
    names = [name.strip() for name in args.checks.split(",")]
    for name in names:
        if name not in FNS:
            raise SystemExit(f"unknown check {name!r}; valid: {CHECKS}")
    failed = 0
    lines = []
    with _lay_shards(device, MESH_SHARDS):
        for name in names:
            tmp = tempfile.mkdtemp(prefix=f"soak-{name}-")
            t0 = time.perf_counter()
            try:
                extra = FNS[name](args.n, tmp, device)
                synchronize(device)
                line = {"check": name, "ok": True,
                        "s": round(time.perf_counter() - t0, 1), **extra}
            except Exception as e:  # noqa: BLE001 (run all, report each)
                failed += 1
                line = {"check": name, "ok": False,
                        "error": f"{type(e).__name__}: {e}"[:300]}
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            print(json.dumps(line), flush=True)
            lines.append(line)
    write_record(args.out, {"results": lines, **device_fields(device)})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
