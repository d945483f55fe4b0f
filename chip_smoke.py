"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of ``heatmap_tpu_torch`` from the sources in
this checkout and holds each kernel against its plain PyTorch version on
the card, at the shapes its paths give it, at larger ones and on the
edge cases of ``heatmap_tpu_torch.kernel_cases`` (bit-equal, or within
the stated ``rtol`` for fractional float weights; the segment reduce 20
times per case, each weighted window case 5 times). Then it
drives the port's paths, each with the kernels' launch counts set to 0
just before it and read just after:

- the single-shot batch job, ``run_job``, at the default z21 -> z6
  cascade with native decode and JSON egress, checked against the
  scatter backend, the CPU and the reference's scalar projection
  (segment-reduce kernel);
- the same 4M-point job chunked (``max_points_in_flight``, four 1M-point
  chunks fed to the card by the CUDA-stream feeder), in RAM and with a
  spill dir, each equal to the single-shot blobs, with 16 segment-reduce
  launches a chunk;
- the fast path: the same points written as a CSV, run through the
  native decoder (``run_job_fast``) and the string path, then converted
  to HMPB and run from the memory map, each equal to the single-shot
  blobs;
- ``run_job_resumable`` on 1M points, failed at one batch by a
  ``FaultInjector`` and resumed to the uninterrupted blobs;
- the ``tiles`` command at its defaults (the bucketed partitioned
  kernels), with ``--weighted`` (their weighted twin) and on a one-tile
  window (the window-histogram kernel), each raster bit-equal and each
  PNG tree byte-identical to the same run on the CPU;
- the headline step, ``python -m heatmap_tpu_torch.bench`` at its
  defaults (with its stage split), checked against the plain scatter;

and the Gaussian splat's convolutions on the card against the CPU.

Prints one JSON line per phase, then the kernels' summary line, the
card's name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises and exits non-zero; without a CUDA device, or
without the package beside this file, it exits non-zero before printing
any result. It imports nothing of JAX and nothing of ``heatmap_tpu``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: Peak HBM rate of an H100 SXM (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
SENTINEL = torch.iinfo(torch.int64).max
N_MAIN = 4_000_000
#: Chunk of the chunked phase: the 4M-point job in four chunks.
N_BOUNDED_CHUNK = 1_000_000
N_WEIGHTED = 1_000_000
N_CROSSCHECK = 200_000
WEIGHT_BOUND = 100
#: Runs of the segment reduce per case, each compared with the plain
#: version: a missing fence in the look-back shows only now and then.
REPEATS = 20
#: Runs of each weighted window case: float atomics add in another order
#: each run, and integer weights must stay bit-equal in every one.
WEIGHTED_REPEATS = 5
#: Points of the window-kernel phases and of the headline step.
N_WINDOW = 1 << 25
N_TILES = 4_000_000
#: Fractional float32 weights sum in another order on each side
#: (atomics), so the kernel and its plain version are each held to the
#: float64 sum of the same weights, within f32 rounding (the JAX
#: package's bound for its weighted kernels). A hot cell of the 2^25
#: clustered points takes about 2e5 terms; a random-walk rounding error
#: of sqrt(k) * 2^-24 is then about 3e-5, and this is 3x that. The CPU
#: tests, at their sizes, hold 1e-5.
FRACTIONAL_RTOL = 1e-4
#: One z8 tile (256 x 256 cells at z16) east of the synthetic hot spot:
#: the tiles command's window-histogram case.
SMALL_TILES_BOUNDS = ("--lat-min", "47.1", "--lat-max", "47.95",
                      "--lon-min", "-122.33", "--lon-max", "-121.0")


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


def device_us(fn, iters=10):
    """Device time per call of ``fn`` (us) by kernel, from torch.profiler's
    CUDA activity over ``iters`` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", 0)
        if total > 0:
            name = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + total / iters
    return out


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
    bit for bit, REPEATS times per case: at the main path's keys and at
    the edge cases of ``kernel_cases`` (runs over tile edges, capacity
    cuts and sentinel tails at tile edges, one key, all sentinels, at the
    cascade's shifts; counts and bounded-integer weights, overflow and
    poison). Then timed at the main path's shape and at each level of
    the default cascade."""
    from heatmap_tpu_torch import kernel_cases as kc
    from heatmap_tpu_torch.ops import sparse_partitioned as sp

    agg = sp.aggregate_sorted_keys_partitioned
    skeys, data, n_slots = main_path_keys(N_MAIN, dev)
    n = skeys.shape[0]
    n_unique0 = int(torch.unique_consecutive(
        skeys[skeys != SENTINEL]).shape[0])
    checks = []

    def check(name, keys, capacity, shift=0, sentinel=SENTINEL, **kw):
        want = sp._plain(keys, capacity, sentinel, shift,
                         kw.get("sorted_weights"), kw.get("weight_bound"))
        for _ in range(REPEATS):
            got = agg(keys, capacity, sentinel=sentinel, shift=shift, **kw)
            torch.cuda.synchronize()
            assert_bit_equal(got, want, name)
        checks.append({"case": name, "n": int(keys.shape[0]),
                       "capacity": capacity, "n_unique": int(got[2]),
                       "runs": REPEATS})
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

    # The edge cases, at every cascade shift, counts and weights.
    for case in kc.SEGMENT_CASES:
        keys_np, capacity = kc.segment_case(case)
        keys = torch.as_tensor(keys_np, device=dev)
        for shift in kc.SEGMENT_SHIFTS:
            check(f"{case}_shift{shift}", keys, capacity, shift=shift,
                  sentinel=SENTINEL >> shift)
        wc = torch.as_tensor(kc.segment_weights(keys_np, WEIGHT_BOUND),
                             device=dev)
        check(f"{case}_weighted", keys, capacity, sorted_weights=wc,
              weight_bound=WEIGHT_BOUND)
        if case == "capacity_at_tile_edge":
            for delta in (-1, 1):
                got = check(f"{case}{delta:+d}", keys, capacity + delta)
                assert int(got[2]) > capacity + delta
        if case == "sentinel_tail_mid_tile":
            for lane in (sp.TILE_KEYS - 1, sp.TILE_KEYS):
                bad = wc.clone()
                bad[lane] = float("nan")
                got = check(f"{case}_poison{lane}", keys, capacity,
                            sorted_weights=bad, weight_bound=WEIGHT_BOUND)
                assert int(got[2]) > capacity

    # Timing at the main path's shape: level 0 of the default job.
    capacity = n
    err = max_abs_err(agg(skeys, capacity), sp._plain(
        skeys, capacity, SENTINEL, 0, None, None))
    ms = median_ms(lambda: agg(skeys, capacity))
    plain_ms = median_ms(lambda: sp._plain(skeys, capacity, SENTINEL, 0,
                                           None, None))
    library_ms = median_ms(
        lambda: torch.unique_consecutive(skeys, return_counts=True))
    weighted_ms = median_ms(lambda: agg(skeys, capacity, sorted_weights=w,
                                        weight_bound=WEIGHT_BOUND))
    by_kernel = device_us(lambda: agg(skeys, capacity))
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
                                      "n_unique": n_unique0,
                                      "tile_keys": sp.TILE_KEYS},
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "weighted_ms": weighted_ms, "device_us": by_kernel,
          "level_ms": level_ms, "bound_ms": bound_ms, "bytes": bytes_moved,
          "max_abs_err": err})
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "max_abs_err": err}, data


def phase_run_job(dev):
    """The single-shot path: the default 4M-point job on the card, with
    native decode and JSON egress. Returns its launches and blobs."""
    from heatmap_tpu_torch import native
    from heatmap_tpu_torch.devices import StageTimer
    from heatmap_tpu_torch.io import MemorySink, SyntheticSource
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig, run_job
    from heatmap_tpu_torch.tilemath.mercator import project_points
    from heatmap_tpu_torch.utils.trace import get_tracer

    cfg = BatchJobConfig()
    assert cfg.resolved_cascade_backend(dev) == "partitioned"
    assert native.available(), "native library did not build or load"
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
    tracer = get_tracer()
    tracer.reset()
    project_points.rechecked = 0
    sp.aggregate_sorted_keys_partitioned.launches = 0
    t0 = time.perf_counter()
    blobs = run_job(SyntheticSource(n=N_MAIN, seed=0), sink, cfg,
                    device=dev, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sp.aggregate_sorted_keys_partitioned.launches
    rechecked = project_points.rechecked
    gc.callbacks.remove(on_gc)
    # Egress by tracer span: finalize, JSON formatting, sink writes.
    spans = _span_split(tracer)
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
          "span_s": spans, "gc_ms_by_generation": gc_ms,
          "blobs": len(blobs), "launches": launches,
          "projection_rechecked": rechecked, "native_egress": True,
          "peak_bytes": peak, "equal_to_scatter": True})
    return launches, blobs


def _span_split(tracer):
    """Host seconds by tracer span, and their counts."""
    return {k: {"total_s": v["total_s"], "count": v["count"]}
            for k, v in tracer.report().items()}


def phase_bounded(dev, single):
    """The chunked path: the default job on SyntheticSource(4M, seed 0)
    in 1M-point chunks, fed by the CUDA-stream feeder, in RAM and with a
    spill dir; each equal to the single-shot blobs ``single``, with 16
    segment-reduce launches a chunk. Returns the in-RAM run's launches."""
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig, run_job
    from heatmap_tpu_torch.pipeline.feeder import FeederStats
    from heatmap_tpu_torch.utils.trace import get_tracer

    cfg = BatchJobConfig()
    tracer = get_tracer()
    runs = {}
    for name in ("in_ram", "spill"):
        with tempfile.TemporaryDirectory() as tmp:
            spill_dir = os.path.join(tmp, "spill") if name == "spill" else None
            stats = FeederStats()
            tracer.reset()
            torch.cuda.reset_peak_memory_stats(dev)
            sp.aggregate_sorted_keys_partitioned.launches = 0
            t0 = time.perf_counter()
            blobs = run_job(SyntheticSource(n=N_MAIN, seed=0), None, cfg,
                            max_points_in_flight=N_BOUNDED_CHUNK,
                            overlap_ingest=True, merge_spill_dir=spill_dir,
                            device=dev, feeder_stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = sp.aggregate_sorted_keys_partitioned.launches
            if spill_dir is not None:
                assert os.listdir(spill_dir) == [], "spill files left"
        assert stats.batches == N_MAIN // N_BOUNDED_CHUNK, stats
        assert launches == 16 * stats.batches, (launches, stats)
        assert blobs == single, f"{name}: chunked blobs differ"
        runs[name] = {"seconds": wall, "points_per_s": N_MAIN / wall,
                      "chunks": stats.batches, "launches": launches,
                      "feed_s": stats.feed_s, "wait_s": stats.wait_s,
                      "overlap_pct": stats.overlap_pct,
                      "depth_hwm": stats.depth_hwm,
                      "peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "span_s": _span_split(tracer),
                      "equal_to_single_shot": True}
    emit({"phase": "bounded", "points": N_MAIN,
          "max_points_in_flight": N_BOUNDED_CHUNK, "runs": runs})
    return runs["in_ram"]["launches"]


def write_csv(path, n, seed):
    """The synthetic stream as a CSV file (round-trip float reprs)."""
    from heatmap_tpu_torch.io import SyntheticSource

    with open(path, "w") as f:
        f.write("latitude,longitude,user_id,source,timestamp\n")
        for b in SyntheticSource(n=n, seed=seed).batches(1 << 20):
            f.write("".join(
                f"{a!r},{o!r},{u},{s},{t}\n" for a, o, u, s, t in zip(
                    b["latitude"].tolist(), b["longitude"].tolist(),
                    b["user_id"], b["source"], b["timestamp"])))


def phase_fast(dev, single):
    """The fast path on the single-shot job's points: written as a CSV
    (timed apart), run through the native decoder (``run_job_fast``) and
    the string path (``run_job(CSVSource)``), converted to HMPB by the
    ``convert`` command and run from the memory map; each equal to the
    single-shot blobs, each with 16 segment-reduce launches."""
    from heatmap_tpu_torch import cli
    from heatmap_tpu_torch.io import CSVSource
    from heatmap_tpu_torch.io.hmpb import HMPBSource
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.pipeline.batch import run_job, run_job_fast
    from heatmap_tpu_torch.utils.trace import get_tracer

    tracer = get_tracer()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "points.csv")
        hmpb_path = os.path.join(tmp, "points.hmpb")
        t0 = time.perf_counter()
        write_csv(csv_path, N_MAIN, 0)
        out["write_csv_s"] = time.perf_counter() - t0
        out["csv_bytes"] = os.path.getsize(csv_path)
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            assert cli.main(["convert", "--input", f"csv:{csv_path}",
                             "--output", hmpb_path]) == 0
        out["convert_s"] = time.perf_counter() - t0
        out["convert"] = json.loads(printed.getvalue())
        assert out["convert"]["n"] == N_MAIN, out["convert"]
        out["hmpb_bytes"] = os.path.getsize(hmpb_path)
        jobs = {
            "fast_csv": lambda: run_job_fast(csv_path, device=dev),
            "string_csv": lambda: run_job(CSVSource(csv_path), device=dev),
            "fast_hmpb": lambda: run_job_fast(HMPBSource(hmpb_path),
                                              device=dev),
        }
        for name, job in jobs.items():
            tracer.reset()
            sp.aggregate_sorted_keys_partitioned.launches = 0
            t0 = time.perf_counter()
            blobs = job()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = sp.aggregate_sorted_keys_partitioned.launches
            assert launches == 16, (name, launches)
            assert blobs == single, f"{name}: blobs differ"
            out[name] = {"seconds": wall, "points_per_s": N_MAIN / wall,
                         "launches": launches, "span_s": _span_split(tracer),
                         "equal_to_single_shot": True}
            del blobs
    emit({"phase": "fast", "points": N_MAIN, **out})


def phase_resumable(dev):
    """``run_job_resumable`` on 1M points, failed at batch 2 by a
    FaultInjector, then resumed from its checkpoint: equal to the
    uninterrupted single-shot job."""
    from heatmap_tpu_torch.faults import InjectedFault
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.pipeline.batch import run_job, run_job_resumable
    from heatmap_tpu_torch.utils import CheckpointManager, FaultInjector

    n = N_WEIGHTED
    batch = n // 4
    want = run_job(SyntheticSource(n=n, seed=1), device=dev)
    with tempfile.TemporaryDirectory() as ckpt:
        injector = FaultInjector({2: 1})
        try:
            run_job_resumable(SyntheticSource(n=n, seed=1), ckpt,
                              batch_size=batch, checkpoint_every=1,
                              fault_injector=injector, device=dev)
        except InjectedFault:
            pass
        assert injector.injected == 1
        resumed_from = CheckpointManager(ckpt).latest_step()
        assert resumed_from == 2, resumed_from
        sp.aggregate_sorted_keys_partitioned.launches = 0
        t0 = time.perf_counter()
        got = run_job_resumable(SyntheticSource(n=n, seed=1), ckpt,
                                batch_size=batch, checkpoint_every=1,
                                device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sp.aggregate_sorted_keys_partitioned.launches
    assert launches == 16, launches
    assert got and got == want, "resumed blobs differ"
    emit({"phase": "resumable", "points": n, "batch_size": batch,
          "failed_at_batch": 2, "resumed_from_step": resumed_from,
          "resume_seconds": wall, "launches": launches, "blobs": len(got),
          "equal_to_uninterrupted": True})


def reference_projection(lat, lon, zoom):
    """Rows, columns and validity by the reference's scalar CPython
    ``math`` formula, one point at a time."""
    from heatmap_tpu_torch.tilemath.mercator import _host_row
    from heatmap_tpu_torch.tilemath.tile import _column_from_longitude

    n = 1 << zoom
    rows = np.array([_host_row(x, zoom) for x in np.asarray(lat).tolist()])
    cols = np.array([float(_column_from_longitude(x, zoom))
                     for x in np.asarray(lon).tolist()])
    with np.errstate(invalid="ignore"):
        valid = ((rows >= 0) & (rows < n) & (cols >= 0) & (cols < n))
    return rows, cols, valid


def phase_projection(data, dev):
    """The card's f64 projection against the reference's scalar rows:
    synthetic points, and latitudes within 3 ulps of z21 row edges."""
    from heatmap_tpu_torch.tilemath.mercator import project_points

    def mismatches(lat, lon):
        before = project_points.rechecked
        r, c, v = project_points(torch.as_tensor(lat, device=dev),
                                 torch.as_tensor(lon, device=dev), 21)
        rechecked = project_points.rechecked - before
        wr, wc, wv = reference_projection(lat, lon, 21)
        r, c, v = r.cpu().numpy(), c.cpu().numpy(), v.cpu().numpy()
        bad = (v != wv) | (wv & ((r != wr) | (c != wc)))
        return int(bad.sum()), rechecked

    lat, lon = data["latitude"][:1_000_000], data["longitude"][:1_000_000]
    synthetic, synthetic_rechecked = mismatches(lat, lon)
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
    boundary, boundary_rechecked = mismatches(blat, blon)
    emit({"phase": "projection", "reference": "CPython math",
          "points": int(lat.shape[0]), "mismatches": synthetic,
          "rechecked": synthetic_rechecked,
          "boundary_points": int(blat.shape[0]),
          "boundary_mismatches": boundary,
          "boundary_rechecked": boundary_rechecked})
    assert synthetic == 0, f"{synthetic} synthetic points moved"
    assert boundary == 0, f"{boundary} near-edge points moved"


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


def window_points(n, zoom, dev, proj_dtype):
    """The headline's clustered points, projected on the card."""
    from heatmap_tpu_torch.bench import make_points
    from heatmap_tpu_torch.tilemath.mercator import project_points

    lat, lon = make_points(n)
    return project_points(torch.as_tensor(lat, device=dev),
                          torch.as_tensor(lon, device=dev), zoom,
                          dtype=proj_dtype)


def tiles_args(out, device, *extra):
    from heatmap_tpu_torch.cli import build_parser

    return build_parser().parse_args(
        ["tiles", "--input", f"synthetic:{N_TILES}", "--output", out,
         "--device", device, *extra])


def tiles_call(dev, *extra):
    """``(window, row, col, valid)`` as a ``tiles`` run with ``extra``
    flags gives them to its binning kernel in its first call: its window,
    and its first batch of points (about 2^20 after the ingest filter),
    projected on the card at its zoom and projection dtype."""
    from heatmap_tpu_torch.cli import tiles_window
    from heatmap_tpu_torch.io import open_source
    from heatmap_tpu_torch.pipeline.batch import load_columns
    from heatmap_tpu_torch.tilemath.mercator import project_points

    args = tiles_args("", dev.type, *extra)
    batch = next(iter(open_source(args.input).batches(args.batch_size)))
    cols = load_columns(batch)
    row, col, valid = project_points(
        torch.as_tensor(cols["latitude"], device=dev),
        torch.as_tensor(cols["longitude"], device=dev), args.zoom,
        dtype=torch.float32 if args.no_x64 else torch.float64)
    return tiles_window(args), row, col, valid


def window_cases(window, row, col, valid, dev, hostile=False):
    """(name, row, col, kwargs, exact) cases for a window kernel: counts,
    a mask, integer weights in [0, WEIGHT_BOUND], fractional weights, NaN
    weights on every dropped lane, no mask, all points in one cell (a
    count past 2^24), an empty input; with ``hostile``, uniform points
    over the window and all points outside it."""
    from heatmap_tpu_torch.ops.histogram import localise

    n = row.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    ints = torch.randint(0, WEIGHT_BOUND + 1, (n,), device=dev,
                         generator=g).to(torch.float32)
    frac = torch.rand(n, device=dev, generator=g) * 10.0
    mask = valid & (torch.rand(n, device=dev, generator=g) < 0.7)
    _, _, ok = localise(row, col, window, valid)
    nan_dropped = torch.where(ok, ints, float("nan"))
    one_r = torch.full_like(row, window.row0 + window.height // 2)
    one_c = torch.full_like(col, window.col0 + window.width // 2)
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    cases = [
        ("counts", row, col, {"valid": valid}, True),
        ("mask", row, col, {"valid": mask}, True),
        ("int_weights", row, col, {"valid": valid, "weights": ints}, True),
        ("frac_weights", row, col, {"valid": valid, "weights": frac}, False),
        ("nan_on_dropped", row, col,
         {"valid": valid, "weights": nan_dropped}, True),
        ("no_mask", row, col, {}, True),
        ("one_cell", one_r, one_c, {}, True),
        ("empty", empty, empty, {}, True),
        ("empty_weighted", empty, empty,
         {"weights": torch.empty(0, device=dev)}, True),
    ]
    if hostile:
        ur = torch.randint(window.row0, window.row0 + window.height, (n,),
                           device=dev, generator=g, dtype=torch.int32)
        uc = torch.randint(window.col0, window.col0 + window.width, (n,),
                           device=dev, generator=g, dtype=torch.int32)
        above = window.row0 - 1 - (row.abs() % 1000)
        cases += [
            ("uniform", ur, uc, {}, True),
            ("uniform_int_weights", ur, uc, {"weights": ints}, True),
            ("all_outside", above, col, {"valid": valid}, True),
        ]
    return cases


def check_window_kernel(fn, plain, window, cases, **kw):
    """Each case through the wrapper on the card and through its plain
    version: bit-equal, or, where not exact, both within FRACTIONAL_RTOL
    of the float64 sum of the same weights. A weighted case runs
    WEIGHTED_REPEATS times, each run checked."""
    from heatmap_tpu_torch.ops.histogram import _scatter_window

    checks = []
    for name, row, col, args, exact in cases:
        want = plain(row, col, window, args.get("weights"), args.get("valid"))
        runs = WEIGHTED_REPEATS if "weights" in args else 1
        for _ in range(runs):
            got = fn(row, col, window, **args, **kw)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and got.shape == want.shape, name
            if exact:
                assert torch.equal(got, want), name
        check = {"case": name, "n": int(row.shape[0]), "runs": runs,
                 "bit_equal": bool(torch.equal(got, want)),
                 "max_abs_err": float(
                     (got.double() - want.double()).abs().max())
                 if got.numel() else 0.0,
                 "total": float(got.double().sum())}
        if not exact:
            ref = _scatter_window(row, col, window,
                                  weights=args["weights"].double(),
                                  valid=args.get("valid"),
                                  dtype=torch.float64)
            for side, x in (("kernel", got), ("plain", want)):
                rel = ((x.double() - ref).abs() / ref.abs().clamp(
                    min=1e-30)).max()
                check[f"{side}_max_rel_err"] = float(rel)
                assert float(rel) <= FRACTIONAL_RTOL, (name, side, float(rel))
        assert bool(torch.isfinite(got.float()).all()), name
        checks.append(check)
    return checks


def time_window_kernel(fn, plain, window, row, col, valid, weights=None,
                       profile=False, **kw):
    """ms, plain_ms, library_ms (torch.bincount on the same masked flat
    index), bound_ms and max_abs_err at one shape; with ``profile``, the
    device time by kernel of ``fn`` and of the library call too."""
    from heatmap_tpu_torch.ops.partitioned import cell_ids

    hw = window.height * window.width
    got = fn(row, col, window, weights=weights, valid=valid, **kw)
    want = plain(row, col, window, weights, valid)
    err = float((got.double() - want.double()).abs().max())
    ms = median_ms(lambda: fn(row, col, window, weights=weights,
                              valid=valid, **kw))
    plain_ms = median_ms(lambda: plain(row, col, window, weights, valid))
    # bincount's bins past hw catch the sentinel of dropped points.
    idx = cell_ids(row, col, window, valid).to(torch.int64)
    library_ms = median_ms(lambda: torch.bincount(idx, weights, minlength=hw))
    n = row.shape[0]
    # Least bytes: row and col (int32), valid (1 B) and the weight (f32)
    # read once each; the raster (4 B a cell) written once.
    bytes_moved = n * (4 + 4 + 1 + (4 if weights is not None else 0)) + 4 * hw
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
           "bytes": bytes_moved, "max_abs_err": err,
           "n": int(n), "window": [window.height, window.width]}
    if profile:
        out["device_us"] = device_us(lambda: fn(
            row, col, window, weights=weights, valid=valid, **kw))
        out["library_device_us"] = device_us(
            lambda: torch.bincount(idx, weights, minlength=hw))
    return out


def kernel_case_cases(fields, row, col, valid, dev):
    """(name, row, col, kwargs, exact) cases of one ``kernel_cases``
    window: counts with and without the mask, and each kind of
    ``kernel_cases.window_weights``."""
    from heatmap_tpu_torch import kernel_cases as kc

    t = [torch.as_tensor(x, device=dev) for x in (row, col, valid)]
    cases = [("counts", t[0], t[1], {"valid": t[2]}, True),
             ("no_mask", t[0], t[1], {}, True)]
    for kind in kc.WEIGHT_KINDS:
        w = torch.as_tensor(kc.window_weights(kind, fields, row, col, valid),
                            device=dev)
        cases.append((f"{kind}_weights", t[0], t[1],
                      {"valid": t[2], "weights": w}, kind != "fractional"))
    return cases


def int_weights(n, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    return torch.randint(0, WEIGHT_BOUND + 1, (n,), device=dev,
                         generator=g).to(torch.float32)


def phase_kernel_window_histogram(dev):
    """The window-histogram kernel (banded) against its plain version: at
    the one-tile ``tiles`` run's shape (its 256x256 z16 window, one
    2^20-point batch), on the ``kernel_cases`` histogram windows (256x256,
    255x257, one row, points where bands meet, a cell past 2^16), and
    over 2^25 points on a 256x256 z15 window around the synthetic hot
    spot, a 32x32 blob window, a 4x32768 window of four bands and a
    16x32768 window too wide for the bands (the kernel's global-atomic
    build). Timed at the ``tiles`` shape (the kernels line) and at the
    256x256 z15 window, each with its ``device_us``."""
    from heatmap_tpu_torch import interop
    from heatmap_tpu_torch import kernel_cases as kc
    from heatmap_tpu_torch.ops import pallas_kernels as pk
    from heatmap_tpu_torch.ops.histogram import Window
    from heatmap_tpu_torch.tilemath.tile import (
        _column_from_longitude,
        _row_from_latitude,
    )

    fn = pk.bin_rowcol_window_pallas
    checks = {}
    plans = {}
    for case in kc.HISTOGRAM_CASES:
        fields, row, col, valid = kc.histogram_case(case)
        window = interop.window_from_fields(**fields)
        checks[case] = check_window_kernel(
            fn, pk._plain, window,
            kernel_case_cases(fields, row, col, valid, dev))
        plans[case] = dataclasses.asdict(pk.plan_histogram(
            window, row.shape[0], pk._sms(dev.index)))

    # The path's own shape: what the one-tile tiles run passes the kernel.
    window, row, col, valid = tiles_call(dev, *SMALL_TILES_BOUNDS)
    assert (window.zoom, window.height, window.width) == (16, 256, 256)
    checks["tiles_256x256_z16"] = check_window_kernel(
        fn, pk._plain, window, window_cases(window, row, col, valid, dev))
    ints = int_weights(row.shape[0], dev)
    plans["tiles"] = dataclasses.asdict(pk.plan_histogram(
        window, row.shape[0], pk._sms(dev.index)))
    tiles_counts = time_window_kernel(fn, pk._plain, window, row, col, valid,
                                      profile=True)
    tiles_weighted = time_window_kernel(fn, pk._plain, window, row, col,
                                        valid, ints, profile=True)
    del row, col, valid, ints

    row, col, valid = window_points(N_WINDOW, 15, dev, torch.float64)
    hot_r, hot_c = _row_from_latitude(47.6, 15), _column_from_longitude(
        -122.3, 15)
    windows = {
        "256x256": Window(15, hot_r - 128, hot_c - 128, 256, 256),
        "32x32": Window(15, hot_r - 16, hot_c - 16, 32, 32),
        # 4 x 32768 cells take four 128 KiB bands; 16 x 32768 more than
        # MAX_BANDS, so the global-atomic build.
        "4x32768": Window(15, hot_r - 2, 0, 4, 1 << 15),
        "16x32768": Window(15, hot_r - 8, 0, 16, 1 << 15),
    }
    for wname, window in windows.items():
        checks[wname] = check_window_kernel(
            fn, pk._plain, window, window_cases(window, row, col, valid, dev))
        plans[wname] = dataclasses.asdict(pk.plan_histogram(
            window, N_WINDOW, pk._sms(dev.index)))
    assert plans["16x32768"]["bands"] == 0, plans
    big = windows["256x256"]
    ints = int_weights(row.shape[0], dev)
    counts = time_window_kernel(fn, pk._plain, big, row, col, valid,
                                profile=True)
    weighted = time_window_kernel(fn, pk._plain, big, row, col, valid, ints,
                                  profile=True)
    small = time_window_kernel(fn, pk._plain, windows["32x32"], row, col,
                               valid)
    wide = time_window_kernel(fn, pk._plain, windows["4x32768"], row, col,
                              valid)
    emit({"phase": "kernel_window_histogram", "bit_equal": True,
          "fractional_rtol": FRACTIONAL_RTOL,
          "weighted_repeats": WEIGHTED_REPEATS, "checks": checks,
          "plans": plans,
          "tiles_counts": tiles_counts, "tiles_int_weights": tiles_weighted,
          "counts": counts, "int_weights": weighted,
          "counts_32x32": small, "counts_4x32768": wide})
    return tiles_counts


def global_build_counts(row, col, window, weights=None, valid=None):
    """Counts through the window-histogram kernel's global-atomic build
    (``hm_window_histogram_counts_global``) at any window: the sort-free
    alternative that the bucketed counts kernel was measured against."""
    from heatmap_tpu_torch import _build
    from heatmap_tpu_torch.ops.pallas_kernels import check_launch

    assert weights is None
    lib = _build.load("window_histogram", (
        ("hm_window_histogram_counts_global",
         (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
          ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)),))
    out = torch.empty(window.height, window.width, dtype=torch.int32,
                      device=row.device)  # zeroed by the entry point
    check_launch(lib.hm_window_histogram_counts_global(
        row.data_ptr(), col.data_ptr(),
        None if valid is None else valid.data_ptr(), row.shape[0],
        window.row0, window.col0, window.height, window.width,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "hm_window_histogram_counts_global")
    return out


def phase_kernel_window_partitioned(dev):
    """The bucketed partitioned kernels, counts and weights, against
    their plain version: on the ``kernel_cases`` windows (ragged
    sub-blocks, sub-block edges, a hot sub-block split into work items,
    all outside; counts and every weight kind), at the default ``tiles``
    run's shape (its 1792x1280 z16 window, one 2^20-point batch), and at
    the headline window (4096x4096, 2^25 points, f32 projection), each
    with uniform and all-outside points too, the headline with streams 1
    and 8. Each weighted case runs WEIGHTED_REPEATS times. Counts are
    timed at the headline (the kernels line: a path of their own) and
    weights at the ``tiles --weighted`` shape (their only path), each at
    the other shape as well and each with its ``device_us``; the
    window-histogram kernel's global-atomic build is checked and timed
    at both windows beside them."""
    from heatmap_tpu_torch import interop
    from heatmap_tpu_torch import kernel_cases as kc
    from heatmap_tpu_torch.bench import headline_window
    from heatmap_tpu_torch.ops import partitioned as pt

    fn = pt.bin_rowcol_window_partitioned
    checks = {}
    for case in kc.WINDOW_CASES:
        fields, row, col, valid = kc.window_case(case)
        window = interop.window_from_fields(**fields)
        checks[case] = check_window_kernel(
            fn, pt._plain, window,
            kernel_case_cases(fields, row, col, valid, dev))
    window, row, col, valid = tiles_call(dev)
    assert (window.zoom, window.height, window.width) == (16, 1792, 1280)
    checks["tiles_1792x1280_z16"] = check_window_kernel(
        fn, pt._plain, window,
        window_cases(window, row, col, valid, dev, hostile=True))
    checks["tiles_global_build"] = check_window_kernel(
        global_build_counts, pt._plain, window,
        [("counts", row, col, {"valid": valid}, True)])
    ints = int_weights(row.shape[0], dev)
    tiles_counts = time_window_kernel(fn, pt._plain, window, row, col, valid,
                                      profile=True)
    tiles_global = time_window_kernel(global_build_counts, pt._plain, window,
                                      row, col, valid)
    tiles_weighted = time_window_kernel(fn, pt._plain, window, row, col,
                                        valid, ints, profile=True)
    del row, col, valid, ints

    window = headline_window()
    row, col, valid = window_points(N_WINDOW, 15, dev, torch.float32)
    cases = window_cases(window, row, col, valid, dev, hostile=True)
    for k in (1, 8):
        checks[f"headline_streams{k}"] = check_window_kernel(
            fn, pt._plain, window, cases, streams=k)
    del cases
    checks["headline_global_build"] = check_window_kernel(
        global_build_counts, pt._plain, window,
        [("counts", row, col, {"valid": valid}, True)])
    counts = time_window_kernel(fn, pt._plain, window, row, col, valid,
                                profile=True)
    global_build = time_window_kernel(global_build_counts, pt._plain, window,
                                      row, col, valid)
    ints = int_weights(row.shape[0], dev)
    weighted = time_window_kernel(fn, pt._plain, window, row, col, valid,
                                  ints, profile=True)
    emit({"phase": "kernel_window_partitioned", "bit_equal": True,
          "fractional_rtol": FRACTIONAL_RTOL,
          "weighted_repeats": WEIGHTED_REPEATS, "checks": checks,
          "plan": {"headline": dataclasses.asdict(
                       pt.plan_counts(window, N_WINDOW)),
                   "sub_side": pt.SUB_SIDE,
                   "item_points": pt.ITEM_POINTS},
          "tiles_counts": tiles_counts, "tiles_int_weights": tiles_weighted,
          "tiles_global_build": tiles_global,
          "counts": counts, "int_weights": weighted,
          "global_build": global_build})
    return counts, tiles_weighted


def read_tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def phase_tiles(dev):
    """The ``tiles`` command on the card, each raster bit-equal and each
    PNG tree byte-identical to the same run with ``--device cpu``:
    defaults on synthetic points (the partitioned kernel), ``--weighted``
    on integer values (its weighted twin), and a one-tile window (the
    histogram kernel)."""
    from heatmap_tpu_torch.cli import run_tiles
    from heatmap_tpu_torch.ops import pallas_kernels as pk
    from heatmap_tpu_torch.ops import partitioned as pt

    def counters():
        return {"window_histogram": pk.bin_rowcol_window_pallas.launches,
                "window_partitioned":
                    pt.bin_rowcol_window_partitioned.launches,
                "window_partitioned_weighted":
                    pt.bin_rowcol_window_partitioned.weighted_launches}

    def zero():
        pk.bin_rowcol_window_pallas.launches = 0
        pt.bin_rowcol_window_partitioned.launches = 0
        pt.bin_rowcol_window_partitioned.weighted_launches = 0

    runs = {
        "default": ((), None, "partitioned", "window_partitioned"),
        "weighted": (("--weighted",), lambda: ValuedSource(N_TILES, seed=3),
                     "partitioned", "window_partitioned_weighted"),
        "small_window": (SMALL_TILES_BOUNDS, None, "pallas",
                         "window_histogram"),
    }
    launches = {}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (extra, make_source, backend, kernel) in runs.items():
            trees = {}
            summaries = {}
            rasters = {}
            for side, device in (("card", dev.type), ("cpu", "cpu")):
                out = os.path.join(tmp, name, side)
                args = tiles_args(out, device, *extra)
                source = make_source() if make_source else None
                if side == "card":
                    zero()
                summaries[side], raster = run_tiles(args, source=source)
                if side == "card":
                    torch.cuda.synchronize()
                    used = counters()
                rasters[side] = raster.cpu()
                trees[side] = read_tree(out)
            card = summaries["card"]
            assert card["bin_backend"] == backend, (name, card)
            assert used[kernel] > 0, (name, used)
            # Counts, and integer weights with per-cell sums far below
            # 2^24, are exact on both sides: the rasters are bit-equal.
            assert rasters["card"].dtype == rasters["cpu"].dtype, name
            assert torch.equal(rasters["card"], rasters["cpu"]), name
            assert trees["card"] and trees["card"] == trees["cpu"], name
            launches[kernel] = used[kernel]
            results[name] = {"tiles": card["tiles"], "window": card["window"],
                             "bin_backend": card["bin_backend"],
                             "seconds": card["seconds"],
                             "stage_ms": card["stage_ms"],
                             "cpu_seconds": summaries["cpu"]["seconds"],
                             "launches": used, "png_bytes": sum(
                                 len(b) for b in trees["card"].values()),
                             "raster_max": float(rasters["card"].max()),
                             "raster_equal_to_cpu": True,
                             "equal_to_cpu": True}
    emit({"phase": "tiles", "points": N_TILES, "runs": results})
    return launches


def phase_splat(dev):
    """The Gaussian splat's two convolutions on the card (TF32 off)
    against the CPU, on a raster of the tiles defaults' shape."""
    from heatmap_tpu_torch.ops.splat import gaussian_kernel_1d, splat_raster

    g = torch.Generator().manual_seed(2)
    raster = torch.randint(1, 1000, (1792, 1280), generator=g,
                           dtype=torch.int32)
    kernel = gaussian_kernel_1d(9)
    card = splat_raster(raster.to(dev), kernel).cpu()
    host = splat_raster(raster, kernel)
    rel = float(((card - host).abs() / host.abs()).max())
    emit({"phase": "splat", "shape": list(raster.shape), "max_rel_err": rel})
    # TF32 keeps 10 mantissa bits (about 1e-3); f32 agrees far closer.
    assert rel <= 1e-6, rel


def phase_headline(dev):
    """``python -m heatmap_tpu_torch.bench`` at its defaults, and its step
    on the card against the plain scatter at the same points."""
    from heatmap_tpu_torch import bench

    rec = bench.run(device=dev)
    assert rec["bin_backend_resolved"] == "partitioned", rec
    assert rec["launches_per_step"] == 1, rec
    split = rec["split_ms"]
    assert set(split) == {"project", "bin", "pyramid", "sum_sync"}, split
    assert all(v > 0 for v in split.values()), split
    window = bench.headline_window()
    lat, lon = bench.make_points(N_WINDOW)
    lat = torch.as_tensor(lat, device=dev)
    lon = torch.as_tensor(lon, device=dev)
    _, pyr = bench.step(lat, lon, window, 15, "auto")
    _, plain = bench.step(lat, lon, window, 15, "xla")
    assert len(pyr) == len(plain) == 13
    assert all(torch.equal(a, b) for a, b in zip(pyr, plain))
    assert int(pyr[-1].sum()) == rec["total"] > 0
    rec["equal_to_plain_scatter"] = True
    emit({"phase": "headline", **rec})
    return rec


def kernel_entry(name, source, replaces, launches, timing):
    return {"name": name, "route": "cuda",
            "source": f"heatmap_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": "bytes", "library_ms": timing["library_ms"]}


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
    histogram = phase_kernel_window_histogram(dev)
    part_counts, part_weighted = phase_kernel_window_partitioned(dev)
    torch.cuda.empty_cache()
    _, single = phase_run_job(dev)
    phase_projection(data, dev)
    del data
    bounded_launches = phase_bounded(dev, single)
    phase_fast(dev, single)
    del single
    phase_resumable(dev)
    phase_weighted(dev)
    phase_cpu_crosscheck(dev)
    tiles_launches = phase_tiles(dev)
    phase_splat(dev)
    phase_headline(dev)
    emit({"kernels": [
        kernel_entry("segment_reduce", "segment_reduce.cu",
                     "heatmap_tpu/ops/sparse_partitioned.py:75",
                     bounded_launches, kernel),
        kernel_entry("window_histogram", "window_histogram.cu",
                     "heatmap_tpu/ops/pallas_kernels.py:49",
                     tiles_launches["window_histogram"], histogram),
        kernel_entry("window_partitioned", "window_bucketed.cu",
                     "heatmap_tpu/ops/partitioned.py:104",
                     tiles_launches["window_partitioned"], part_counts),
        kernel_entry("window_partitioned_weighted", "window_bucketed.cu",
                     "heatmap_tpu/ops/partitioned.py:137",
                     tiles_launches["window_partitioned_weighted"],
                     part_weighted),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
