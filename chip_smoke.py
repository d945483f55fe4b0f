"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of ``heatmap_tpu_torch`` from the sources in
this checkout, holds each kernel bit-equal to its plain PyTorch version
on the card, drives the port's main path (the single-shot batch job,
``run_job``, at the default z21 -> z6 cascade) and checks its output
against the scatter backend, the CPU and the host projection. Prints one
JSON line per phase, then the kernels' summary line, the card's name and
power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises and exits non-zero; without a CUDA device, or
without the package beside this file, it exits non-zero before printing
any result. It imports nothing of JAX and nothing of ``heatmap_tpu``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: Peak HBM rate of an H100 SXM (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
SENTINEL = torch.iinfo(torch.int64).max
N_MAIN = 4_000_000
N_WEIGHTED = 1_000_000
N_CROSSCHECK = 200_000
WEIGHT_BOUND = 100


def emit(obj):
    print(json.dumps(obj), flush=True)


def median_ms(fn, iters=20, warmup=3):
    """Median device time of ``fn()`` over ``iters`` calls, each timed
    with its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want):
    """Largest absolute difference over (unique, sums, n_unique)."""
    err = 0.0
    for g, w in zip(got, want):
        g = g.double().reshape(-1)
        w = w.double().reshape(-1)
        assert g.shape == w.shape, (g.shape, w.shape)
        if g.numel():
            err = max(err, float((g - w).abs().max()))
    return err


def assert_bit_equal(got, want, what):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        assert torch.equal(g, w), what


class ValuedSource:
    """The synthetic stream plus an integer ``value`` column in
    [0, WEIGHT_BOUND], made from the seed."""

    def __init__(self, n, seed):
        from heatmap_tpu_torch.io import SyntheticSource

        self.inner = SyntheticSource(n=n, seed=seed)
        self.seed = seed

    def batches(self, batch_size):
        for i, b in enumerate(self.inner.batches(batch_size)):
            rng = np.random.default_rng([self.seed, 7, i])
            b["value"] = rng.integers(0, WEIGHT_BOUND + 1,
                                      len(b["latitude"])).astype(np.float64)
            yield b


def main_path_keys(n, dev):
    """The sorted composite keys that the default job's cascade sorts
    (the segment reduce's input at its main-path shape), and the
    ingested columns."""
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.pipeline import batch as B
    from heatmap_tpu_torch.pipeline.cascade import composite_keys
    from heatmap_tpu_torch.pipeline.groups import UserVocab

    cfg = B.BatchJobConfig()
    data = B.ingest_columns(SyntheticSource(n=n, seed=0).batches(1 << 20), cfg)
    group_ids = UserVocab().group_ids(data["user_id"])
    codes, valid = B.project_codes(data["latitude"], data["longitude"],
                                   cfg.detail_zoom, dev)
    e_codes, e_slots, e_valid, ts_vocab, n_groups, _ = B.build_emissions(
        codes, valid, group_ids, data["timestamp"], cfg)
    n_slots = len(ts_vocab) * n_groups
    ck = composite_keys(e_codes, e_slots, cfg.detail_zoom, n_slots)
    skeys = torch.sort(torch.where(e_valid, ck, SENTINEL)).values
    return skeys, data, n_slots


def phase_device():
    from heatmap_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels": _build.sources(), "build_s": build_s})
    return smi


def phase_kernel(dev):
    """The segment-reduce kernel against its plain version, on the card,
    bit for bit, then timed at the main path's shape."""
    from heatmap_tpu_torch.ops import sparse_partitioned as sp

    agg = sp.aggregate_sorted_keys_partitioned
    skeys, data, n_slots = main_path_keys(N_MAIN, dev)
    n = skeys.shape[0]
    n_unique0 = int(torch.unique_consecutive(
        skeys[skeys != SENTINEL]).shape[0])
    checks = []

    def check(name, keys, capacity, shift=0, sentinel=SENTINEL, **kw):
        got = agg(keys, capacity, sentinel=sentinel, shift=shift, **kw)
        want = sp._plain(keys, capacity, sentinel, shift,
                         kw.get("sorted_weights"), kw.get("weight_bound"))
        torch.cuda.synchronize()
        assert_bit_equal(got, want, name)
        checks.append({"case": name, "n": int(keys.shape[0]),
                       "capacity": capacity, "n_unique": int(got[2])})
        return got

    # Composite z21 keys with their sentinel padding, at three cascade
    # shifts, each against its shifted sentinel.
    for shift in (0, 10, 30):
        check(f"z21_shift{shift}", skeys, n, shift=shift,
              sentinel=SENTINEL >> shift)
    # Capacity below the unique count: the overflow signal.
    got = check("overflow", skeys, n_unique0 // 2)
    assert int(got[2]) > n_unique0 // 2
    # Explicit sentinel padding at the stream's tail.
    padded = torch.cat([skeys[: n // 2],
                        torch.full((4097,), SENTINEL, device=dev)])
    check("sentinel_tail", padded, n // 2)
    check("empty", torch.empty(0, dtype=torch.int64, device=dev), 64)
    # Bounded-integer weights, then one invalid weight that poisons
    # n_unique.
    g = torch.Generator(device="cpu").manual_seed(0)
    w = torch.randint(0, WEIGHT_BOUND + 1, (n,), generator=g,
                      dtype=torch.int64).to(torch.float64).to(dev)
    check("weighted", skeys, n, sorted_weights=w, weight_bound=WEIGHT_BOUND)
    w_bad = w.clone()
    w_bad[n // 3] = 2.5
    got = check("weighted_poison", skeys, n, sorted_weights=w_bad,
                weight_bound=WEIGHT_BOUND)
    assert int(got[2]) > n

    # Timing at the main path's shape: level 0 of the default job.
    capacity = n
    err = max_abs_err(agg(skeys, capacity), sp._plain(
        skeys, capacity, SENTINEL, 0, None, None))
    ms = median_ms(lambda: agg(skeys, capacity))
    plain_ms = median_ms(lambda: sp._plain(skeys, capacity, SENTINEL, 0,
                                           None, None))
    library_ms = median_ms(
        lambda: torch.unique_consecutive(skeys, return_counts=True))
    # Every level of the default cascade alone, at its shift, shifted
    # sentinel and zoom-clamped capacity (as pipeline/cascade.py sets
    # them), away from the job's host work.
    level_ms = [
        median_ms(lambda lvl=lvl: agg(
            skeys, min(n, n_slots << (2 * (21 - lvl))),
            sentinel=SENTINEL >> (2 * lvl), shift=2 * lvl), iters=10)
        for lvl in range(16)
    ]
    # Least bytes: the keys read once; unique int64 + int32 counts
    # written once per output slot, and n_unique.
    bytes_moved = 8 * n + 12 * capacity + 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    emit({"phase": "kernel_segment_reduce", "bit_equal": True,
          "checks": checks, "shape": {"n": n, "capacity": capacity,
                                      "n_unique": n_unique0},
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "level_ms": level_ms, "bound_ms": bound_ms, "bytes": bytes_moved,
          "max_abs_err": err})
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "max_abs_err": err}, data


def phase_run_job(dev):
    """The main path: the default 4M-point job on the card."""
    from heatmap_tpu_torch.devices import StageTimer
    from heatmap_tpu_torch.io import MemorySink, SyntheticSource
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig, run_job

    cfg = BatchJobConfig()
    assert cfg.resolved_cascade_backend(dev) == "partitioned"
    timer = StageTimer(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    sink = MemorySink()
    gc_ms = {0: 0.0, 1: 0.0, 2: 0.0}
    gc_t = [0.0]

    def on_gc(phase, info):
        # Host time spent in Python's collector, by generation.
        if phase == "start":
            gc_t[0] = time.perf_counter()
        else:
            gc_ms[info["generation"]] += (time.perf_counter() - gc_t[0]) * 1e3

    gc.callbacks.append(on_gc)
    sp.aggregate_sorted_keys_partitioned.launches = 0
    t0 = time.perf_counter()
    blobs = run_job(SyntheticSource(n=N_MAIN, seed=0), sink, cfg,
                    device=dev, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sp.aggregate_sorted_keys_partitioned.launches
    gc.callbacks.remove(on_gc)
    peak = torch.cuda.max_memory_allocated(dev)
    assert launches == cfg.cascade_config().n_levels + 1 == 16, launches
    assert blobs and sink.blobs == blobs
    for k, v in list(blobs.items())[:1000]:
        body = json.loads(v)
        assert body and all(math.isfinite(x) and x > 0 for x in body.values())
    scatter = run_job(SyntheticSource(n=N_MAIN, seed=0), None,
                      BatchJobConfig(cascade_backend="scatter"), device=dev)
    assert scatter == blobs, "partitioned and scatter blobs differ"
    stages = {k: sum(v) for k, v in timer.ms.items()}
    emit({"phase": "run_job", "points": N_MAIN, "seconds": wall,
          "points_per_s": N_MAIN / wall, "stage_ms": stages,
          "segment_reduce_ms": timer.ms.get("segment_reduce"),
          "gc_ms_by_generation": gc_ms,
          "blobs": len(blobs), "launches": launches,
          "peak_bytes": peak, "equal_to_scatter": True})
    return launches


def phase_projection(data, dev):
    """The card's f64 projection against the host's numpy projection."""
    from heatmap_tpu_torch.tilemath.mercator import (
        project_points,
        project_points_np,
    )

    def mismatches(lat, lon):
        r, c, v = project_points(torch.as_tensor(lat, device=dev),
                                 torch.as_tensor(lon, device=dev), 21)
        nr, nc, nv = project_points_np(lat, lon, 21)
        r, c, v = r.cpu().numpy(), c.cpu().numpy(), v.cpu().numpy()
        return int(((r != nr) | (c != nc) | (v != nv)).sum())

    lat, lon = data["latitude"], data["longitude"]
    synthetic = mismatches(lat, lon)
    # Latitudes within a few ulps of z21 row edges.
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 1 << 21, 100_000)
    n = math.pi - 2.0 * math.pi * rows / float(1 << 21)
    edge = 180.0 / math.pi * np.arctan(0.5 * (np.exp(n) - np.exp(-n)))
    near = [edge]
    up = down = edge
    for _ in range(3):
        up = np.nextafter(up, np.inf)
        down = np.nextafter(down, -np.inf)
        near += [up, down]
    blat = np.concatenate(near)
    blon = rng.uniform(-180, 180, blat.shape[0])
    boundary = mismatches(blat, blon)
    emit({"phase": "projection", "points": int(lat.shape[0]),
          "mismatches": synthetic, "boundary_points": int(blat.shape[0]),
          "boundary_mismatches": boundary})
    assert synthetic == 0, f"{synthetic} synthetic points moved"


def phase_weighted(dev):
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig, run_job

    src = ValuedSource(N_WEIGHTED, seed=2)
    part_cfg = BatchJobConfig(weighted=True, weight_bound=WEIGHT_BOUND,
                              cascade_backend="partitioned")
    t0 = time.perf_counter()
    part = run_job(src, None, part_cfg, device=dev)
    wall = time.perf_counter() - t0
    scatter = run_job(src, None,
                      BatchJobConfig(weighted=True, cascade_backend="scatter"),
                      device=dev)
    assert part and part == scatter, "weighted blobs differ"
    emit({"phase": "weighted", "points": N_WEIGHTED, "blobs": len(part),
          "seconds": wall, "equal_to_scatter": True})


def phase_cpu_crosscheck(dev):
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.pipeline.batch import run_job

    card = run_job(SyntheticSource(n=N_CROSSCHECK, seed=5), device=dev)
    host = run_job(SyntheticSource(n=N_CROSSCHECK, seed=5), device="cpu")
    assert card and card == host, "card and CPU blobs differ"
    emit({"phase": "cpu_crosscheck", "points": N_CROSSCHECK,
          "blobs": len(card), "equal": True})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    import heatmap_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device()
    kernel, data = phase_kernel(dev)
    launches = phase_run_job(dev)
    phase_projection(data, dev)
    del data
    phase_weighted(dev)
    phase_cpu_crosscheck(dev)
    emit({"kernels": [{
        "name": "segment_reduce",
        "route": "cuda",
        "source": "heatmap_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "heatmap_tpu/ops/sparse_partitioned.py:75",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": "bytes",
        "library_ms": kernel["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
