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
- the same 4M-point job with ``adaptive_capacity=True`` (equal blobs,
  16 launches at shrunken output shapes), and 200k points read from a
  Parquet file by the ``run`` command (equal to the CSV run's bytes);
- the ``tiles`` command at its defaults (the bucketed partitioned
  kernels), with ``--weighted`` (their weighted twin) and on a one-tile
  window (the window-histogram kernel), each raster bit-equal and each
  PNG tree byte-identical to the same run on the CPU;
- the ``stream`` command (a decayed live raster, one binning launch a
  tick): at its defaults on 4M synthetic points (the window-histogram
  kernel), at z16 in 1M-point ticks (the bucketed kernels, counts and
  integer weights), and resumed from a checkpoint written halfway
  through a CSV (bit-equal to the uninterrupted run); each against the
  same run on the CPU (bit-equal without decay, within STREAM_RTOL with
  it), and a twin of ``tools/bench_stream.py`` per binning backend;
- the delta store through ``update`` and ``retract`` (a 1M-point base,
  262,144-point increments, a duplicate, retractions, a compaction),
  checked against a one-shot run over the surviving points and against
  the same sequence on the CPU (16 segment-reduce launches per applied
  batch);
- the ``ingest`` command at its defaults over 512k synthetic points (32
  ticks, 2 compactions), onto the delta phase's store, replayed as
  duplicates, partly retracted, with every telemetry flag on, and
  weighted on the card and the CPU: each store checked against a
  one-shot run, the exact-padded synchronous drain and each other (16
  launches per applied tick, none per duplicate);
- serving: ``delta:`` over the delta phase's store in a ``ServeApp``,
  1,100 tiles (png and json) fetched cold and warm over HTTP; ``ingest
  --serve-port 0`` (8 ticks) onto a fresh store while a client
  fetches, every touched cached tile equal to a cold mount's after
  each tick, and the store equal to the same drain without serving and
  on the CPU (16 segment-reduce launches per applied tick); ``serve
  --follow-stream`` for 16 ticks (one window-histogram launch a tick),
  its live raster bit-equal to the port's stream on the CPU;
- the write plane: the ``writeplane`` command at its defaults over
  262,144 points (2 pump threads launching the cascade concurrently, 16
  segment reduces per applied sub-batch), its levels equal to a one-shot
  run and to the exact-padded drain, a replay that applies nothing, 4
  writers with a retraction and a rebalance against a one-shot run over
  the survivors, the card against the CPU, and 1, 2 and 4 writers;
- the serve fleet: ``serve --fleet 2`` over the write plane's root as a
  process, tiles through the router equal to a single-process app's, a
  child SIGKILLed mid-list (no 500; restarted and back on the ring), and
  no process of the fleet holding a CUDA context;
- the temporal plane: ``update --bucket-width 3600`` over a 1M-point
  base and four 131,072-point increments stamped into separate hours, two
  bucketed compactions (the manifest against the bucket ladder), ``retract
  --where`` landing one counter-batch per bucket, ``serve`` as a process
  answering ``?as_of=`` (against a recompute over the batches inside the
  cut), ``?window=`` (1d: against the all-time bytes) and ``?decay=``
  tiles and ``op=topk_growth`` (within its stamped bound), the same
  sequence scaled down on the card and the CPU (equal buckets) and
  without buckets (equal base), and ``ingest --bucket-width
  --serve-port`` whose bucket roll drops exactly the retiring window
  tiles (16 segment-reduce launches per applied batch);
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
import shutil
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
#: The stream command's default micro-batch, and the batch of its z16
#: cases (the 4M points in 4 ticks; a whole number of default batches).
STREAM_BATCH = 1 << 16
STREAM_BIG_BATCH = 1 << 20
#: tools/bench_stream.py's defaults: steps and points per step.
STREAM_BENCH_STEPS = 50
STREAM_BENCH_BATCH = 1 << 18
#: A decayed raster of the card and one of the CPU differ where float32
#: ``exp`` rounds the decay factor differently (an ulp a tick).
STREAM_RTOL = 1e-5
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
#: The delta phase: a base of 1M points, increments of 262,144 points
#: (seeds 1-4), the user a predicate retraction removes; and the small
#: sequence (a 100k base, 200k until the temporal phase came) run on the
#: card and on the CPU. The base is also the ingest
#: phase's (b) store and the serve phase's large store. (The default
#: job's 4M points until the write-plane and fleet phases came, then
#: 2M until the temporal phase came; halved each time to keep the
#: smoke within its time.)
N_DELTA_BASE = 1_000_000
N_DELTA_INC = 1 << 18
N_DELTA_SMALL_BASE = 100_000
N_DELTA_SMALL_INC = 1 << 14
DELTA_USER = "user-3"
#: The ingest phase: the ``ingest`` command's defaults (16,384-point
#: micro-batches, queue depth 4, feed depth 1, pow2 padding over a 4,096
#: floor, compaction every 16 live deltas, retention 2) over
#: ``synthetic:N_INGEST:7``. The drains held against it (exact padding
#: without queue or feeder, telemetry on) and the replay run its first
#: INGEST_CUT_TICKS ticks (up to and through the first compaction) or
#: the INGEST_CUT_TICKS - 1 before it: past a compaction, retention 2
#: keeps only the two newest folded batches' hashes, so a replay of
#: older ticks would apply them again. (b) runs INGEST_B_TICKS ticks
#: onto the delta phase's store; (d) retracts the first
#: N_INGEST_RETRACT points; (f) drains N_INGEST_WEIGHTED weighted points.
#: (2^20 points until the serve phase came; halved to keep the smoke
#: within its time.)
N_INGEST = 1 << 19
INGEST_SEED = 7
INGEST_MICRO = 1 << 14
INGEST_CUT_TICKS = 16
INGEST_B_TICKS = 8
N_INGEST_RETRACT = 1 << 18
N_INGEST_WEIGHTED = 1 << 16
#: The serve phase. (a) and (b) run in one ``ingest --serve-port 0``
#: process at the command's defaults over the delta phase's store: (a)
#: its mount of ``delta:`` and a tile list (the SERVE_TILES most
#: populated tiles over tile zooms SERVE_ZOOMS of all/alltime, an equal
#: share per zoom, plus SERVE_EMPTY empty ones, png and json) fetched
#: cold then warm before the first tick; (b) one tick of INGEST_MICRO
#: points per entry of SERVE_CLIENT_RPS while a client fetches that list
#: at the entry's requests a second (0: no client, so the tick shows
#: the refresh's own cost; None: as fast as one connection goes). No
#: source gives a request rate per serving process, so the rate is a
#: free parameter: the small-store case runs one tick at each rate of
#: SERVE_CURVE_RPS onto a fresh N_SERVE_BASE-point base. Each tick at
#: the delta phase's 37M rows rebuilds the whole overlay index, and the
#: stale check after the last mounts the store cold, each about a
#: minute on an H100 host; with (0, 50) the smoke took 968 s of its
#: 1,200, so (b) runs the one tick that shows the refresh's own cost.
#: The curve ran (0, 50, 200, None) until the temporal phase came; its
#: two ends stay. (c) SERVE_TICKS follow-stream ticks of STREAM_BATCH.
SERVE_TILES = 1000
SERVE_EMPTY = 100
SERVE_ZOOMS = tuple(range(8, 17))
SERVE_CLIENT_RPS = (0,)
SERVE_CURVE_RPS = (0, None)
SERVE_TICKS = 16
N_SERVE_BASE = 1 << 16
#: The write-plane phase: the ``writeplane`` command at its defaults (2
#: writers, 16,384-point micro-batches, queue depth 4, a publish every
#: batch, compaction every 16 live deltas, retention 2, pow2 padding).
#: (a) drains synthetic:N_WRITEPLANE:7, 16 batches (a deployment's
#: stream is endless; 16 batches let each range compact once); (c) 4
#: writers over synthetic:N_WRITEPLANE_C:11 with its first
#: N_WRITEPLANE_RETRACT points retracted, then a rebalance; (d) and the
#: writer curve run (a)'s first WRITEPLANE_CUT_TICKS and
#: WRITEPLANE_CURVE_TICKS batches (8 for the curve until the temporal
#: phase came).
N_WRITEPLANE = 1 << 18
N_WRITEPLANE_C = 1 << 17
N_WRITEPLANE_RETRACT = 1 << 15
WRITEPLANE_CUT_TICKS = 4
WRITEPLANE_CURVE_TICKS = 4
WRITEPLANE_WRITERS = (1, 2, 4)
#: The fleet phase: ``serve --fleet FLEET_BACKENDS`` over (a)'s root, in
#: process mode; FLEET_RESTART_WAIT_S bounds the wait for a killed
#: child's return to the ring.
FLEET_BACKENDS = 2
FLEET_RESTART_WAIT_S = 120.0
#: The temporal phase: ``update --bucket-width 3600`` (the JAX package's
#: other defaults: fanout 4, keep 8, tiers 4, unit 1 s) on a store fed
#: SyntheticSource's clustered metro points with their stamps rewritten
#: into whole hours from TEMPORAL_T0 (the synthetic stamps span a year
#: and a batch lands in the bucket of its largest stamp, so unmodified
#: batches would share one bucket): N_TEMPORAL_BASE points in hour 0,
#: one N_TEMPORAL_INC-point increment in each hour of TEMPORAL_HOURS, a
#: bucketed compaction, one more increment in each of
#: TEMPORAL_LATE_HOURS, ``retract --where user=TEMPORAL_USER`` and a
#: second compaction, at the command's retention (2: the retraction
#: scans the two newest folded entries and the live ones, its horizon;
#: a retention that kept every entry would make every apply and every
#: ``as_of``/``decay`` request read every entry's point payload, the 1M
#: base's among them). Four increments (one an hour over hours 1-15
#: until the smoke's time forced the cut), placed so that the compactions
#: still coarsen hours 0 and 2 into one tier-1 bucket. TEMPORAL_T0 is a
#: multiple of
#: 3600 * 4^3, so every tier's edges fall on whole hours from it.
#: Served: the
#: TEMPORAL_TILES most populated tiles plus TEMPORAL_EMPTY empty ones in
#: each cut, and TEMPORAL_GROWTH_QUERIES ``op=topk_growth`` requests.
#: The card-against-CPU sequence is the same at N_TEMPORAL_SMALL_BASE
#: and N_TEMPORAL_SMALL_INC points with increments in
#: TEMPORAL_SMALL_HOURS (far enough apart for its oldest hours to
#: coarsen); the ``ingest`` case drains TEMPORAL_INGEST_TICKS ticks of
#: INGEST_MICRO points, two per hour across an hour edge, onto a store
#: of one such batch (each served tick rebuilds the whole index, so the
#: roll is shown on the smallest store that has one), with
#: TEMPORAL_ROLL_TILES populated tiles (and a sixth of that empty) served
#: in ``?window=1h``.
TEMPORAL_T0 = 1_700_121_600
N_TEMPORAL_BASE = 1 << 20
N_TEMPORAL_INC = 1 << 17
TEMPORAL_HOURS = (2, 4, 9)
TEMPORAL_LATE_HOURS = (11,)
TEMPORAL_USER = "user-3"
TEMPORAL_AS_OF_HOUR = 8
TEMPORAL_TILES = 150
TEMPORAL_EMPTY = 15
TEMPORAL_ROLL_TILES = 60
TEMPORAL_GROWTH_QUERIES = 50
N_TEMPORAL_SMALL_BASE = 1 << 17
N_TEMPORAL_SMALL_INC = 1 << 15
TEMPORAL_SMALL_HOURS = (3, 6, 9, 12)
TEMPORAL_SMALL_LATE_HOURS = ()
TEMPORAL_INGEST_TICKS = 4
#: Points of the segment reduce's padded-tick case: 2 emissions per
#: kept point fill a little over half of the pow2 bucket, so 40-50% of
#: the sorted lanes are the sentinel tail.
INGEST_PAD_POINTS = 9600
#: One z8 tile (256 x 256 cells at z16) east of the synthetic hot spot:
#: the tiles command's window-histogram case.
SMALL_TILES_BOUNDS = ("--lat-min", "47.1", "--lat-max", "47.95",
                      "--lon-min", "-122.33", "--lon-max", "-121.0")


#: The script's start: each phase line carries its end as ``at_s``
#: seconds after it, so the phases' durations read off the output.
_T0 = time.perf_counter()


def emit(obj):
    """Print one result line; phase lines also go to
    chiprun_out/chip_smoke_phases.jsonl, whole, beyond what the end of
    the output keeps."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_phases.jsonl"),
                  "a") as f:
            f.write(json.dumps(obj) + "\n")
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


def ingest_tick_keys(points, dev):
    """A real ingest tick's segment-reduce input: the first ``points``
    of the ingest phase's source through the batch job's emissions,
    padded to the pow2 bucket as ``pipeline.batch._run_grouped`` pads
    them, as sorted composite keys with integer weights sorted beside
    them (pad lanes weigh 0). Returns (keys, weights, sentinel share)."""
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.pipeline import batch as B
    from heatmap_tpu_torch.pipeline import bucketing
    from heatmap_tpu_torch.pipeline.cascade import composite_keys
    from heatmap_tpu_torch.pipeline.groups import UserVocab

    cfg = B.BatchJobConfig(pad_bucketing="pow2")
    data = B.ingest_columns(
        SyntheticSource(n=points, seed=INGEST_SEED).batches(points), cfg)
    group_ids = UserVocab().group_ids(data["user_id"])
    codes, valid = B.project_codes(data["latitude"], data["longitude"],
                                   cfg.detail_zoom, dev)
    rng = np.random.default_rng([INGEST_SEED, points])
    w = torch.as_tensor(rng.integers(0, WEIGHT_BOUND + 1, len(group_ids))
                        .astype(np.float64), device=dev)
    e_codes, e_slots, e_valid, ts_vocab, n_groups, e_w = B.build_emissions(
        codes, valid, group_ids, data["timestamp"], cfg, weights=w)
    target = bucketing.bucket_size(len(e_codes), "pow2", cfg.pad_bucket_min)
    e_codes, e_slots, e_valid, e_w = bucketing.pad_emissions(
        e_codes, e_slots, e_valid, e_w, target)
    n_slots = bucketing.bucket_slots(len(ts_vocab) * n_groups)
    ck = composite_keys(e_codes, e_slots, cfg.detail_zoom, n_slots)
    skeys, order = torch.sort(torch.where(e_valid, ck, SENTINEL))
    tail = int((skeys == SENTINEL).sum()) / target
    return skeys, e_w[order], tail


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

    # A real ingest tick's keys, padded to its pow2 bucket as the ingest
    # path pads them (pad lanes sort to the sentinel tail), counts and
    # bounded-integer weights: a default 16,384-point tick and one whose
    # sentinel tail is 40-50% of the lanes.
    padded_ticks = []
    for points in (INGEST_MICRO, INGEST_PAD_POINTS):
        tkeys, tw, tail = ingest_tick_keys(points, dev)
        if points == INGEST_PAD_POINTS:
            assert 0.40 <= tail <= 0.50, tail
        nt = tkeys.shape[0]
        for shift in (0, 10, 30):
            check(f"ingest_tick{points}_shift{shift}", tkeys, nt,
                  shift=shift, sentinel=SENTINEL >> shift)
        check(f"ingest_tick{points}_weighted", tkeys, nt, sorted_weights=tw,
              weight_bound=WEIGHT_BOUND)
        padded_ticks.append({"points": points, "lanes": nt,
                             "sentinel_share": tail,
                             "ms": median_ms(lambda: agg(tkeys, nt))})

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
          "padded_ticks": padded_ticks, "max_abs_err": err})
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
    del scatter
    stages = {k: sum(v) for k, v in timer.ms.items()}
    # The same job with adaptive capacities: the segment reduce's output
    # arrays shrink to the real unique counts level by level.
    adaptive_timer = StageTimer(dev)
    sp.aggregate_sorted_keys_partitioned.launches = 0
    t0 = time.perf_counter()
    adaptive = run_job(SyntheticSource(n=N_MAIN, seed=0), None,
                       BatchJobConfig(adaptive_capacity=True), device=dev,
                       timer=adaptive_timer)
    torch.cuda.synchronize()
    adaptive_wall = time.perf_counter() - t0
    adaptive_launches = sp.aggregate_sorted_keys_partitioned.launches
    assert adaptive_launches == 16, adaptive_launches
    assert adaptive == blobs, "adaptive-capacity blobs differ"
    del adaptive
    emit({"phase": "run_job", "points": N_MAIN, "seconds": wall,
          "points_per_s": N_MAIN / wall, "stage_ms": stages,
          "segment_reduce_ms": timer.ms.get("segment_reduce"),
          "span_s": spans, "gc_ms_by_generation": gc_ms,
          "blobs": len(blobs), "launches": launches,
          "projection_rechecked": rechecked, "native_egress": True,
          "peak_bytes": peak, "equal_to_scatter": True,
          "adaptive": {"seconds": adaptive_wall,
                       "launches": adaptive_launches,
                       "segment_reduce_ms": adaptive_timer.ms.get(
                           "segment_reduce"),
                       "cascade_ms": sum(adaptive_timer.ms.get(
                           "segment_reduce", [])) + sum(
                           adaptive_timer.ms.get("sort", [])),
                       "equal_to_single_shot": True},
          "cascade_ms": sum(timer.ms.get("segment_reduce", []))
          + sum(timer.ms.get("sort", []))})
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


def phase_fast(dev, single, csv_path):
    """The fast path on the single-shot job's points: written as a CSV
    at ``csv_path`` (timed apart), run through the native decoder
    (``run_job_fast``) and the string path (``run_job(CSVSource)``),
    converted to HMPB by the ``convert`` command and run from the memory
    map; each equal to the single-shot blobs, each with 16
    segment-reduce launches."""
    from heatmap_tpu_torch import cli
    from heatmap_tpu_torch.io import CSVSource
    from heatmap_tpu_torch.io.hmpb import HMPBSource
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.pipeline.batch import run_job, run_job_fast
    from heatmap_tpu_torch.utils.trace import get_tracer

    tracer = get_tracer()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
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
                    zero_window_counters()
                summaries[side], raster = run_tiles(args, source=source)
                if side == "card":
                    torch.cuda.synchronize()
                    used = window_counters()
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


def phase_parquet(dev):
    """The ``run`` command on the card over the 200k cross-check points
    read from a Parquet file (``parquet:``), and over the same points as
    a CSV: the same blobs. (The CSV takes the fast path, whose user
    slots are numbered in another order, so on the partitioned backend
    the JSONL lines come in another order; the blobs are the same.)"""
    from heatmap_tpu_torch.io import JSONLBlobSink
    import pyarrow as pa
    import pyarrow.parquet as pq

    from heatmap_tpu_torch import cli
    from heatmap_tpu_torch.io import SyntheticSource

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cols = {"latitude": [], "longitude": [], "user_id": [], "source": [],
                "timestamp": []}
        for b in SyntheticSource(n=N_CROSSCHECK, seed=5).batches(1 << 20):
            for k in cols:
                cols[k].append(b[k])
        pq_path = os.path.join(tmp, "points.parquet")
        pq.write_table(pa.table({
            "latitude": np.concatenate(cols["latitude"]),
            "longitude": np.concatenate(cols["longitude"]),
            "user_id": sum(cols["user_id"], []),
            "source": sum(cols["source"], []),
            "timestamp": np.asarray(sum(cols["timestamp"], []), np.int64),
        }), pq_path)
        csv_path = os.path.join(tmp, "points.csv")
        write_csv(csv_path, N_CROSSCHECK, 5)
        jsonl = {}
        for name, spec in (("parquet", f"parquet:{pq_path}"),
                           ("csv", f"csv:{csv_path}")):
            target = os.path.join(tmp, f"{name}.jsonl")
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                assert cli.main(["run", "--input", spec, "--output",
                                 f"jsonl:{target}", "--device",
                                 dev.type]) == 0
            torch.cuda.synchronize()
            summary = json.loads(printed.getvalue().splitlines()[-1])
            assert summary["device"] == dev.type, summary
            out[name] = {"seconds": time.perf_counter() - t0,
                         "summary": summary}
            jsonl[name] = JSONLBlobSink.load(target)
            out[name]["jsonl_bytes"] = os.path.getsize(target)
    assert jsonl["parquet"] and jsonl["parquet"] == jsonl["csv"], \
        "parquet and CSV runs differ"
    emit({"phase": "parquet", "points": N_CROSSCHECK,
          "blobs": len(jsonl["csv"]), "equal_to_csv": True, **out})


def cli_call(argv):
    """``cli.main(argv)`` with its stdout summary captured: (summary,
    seconds)."""
    from heatmap_tpu_torch import cli

    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        assert cli.main(argv) == 0, argv
    torch.cuda.synchronize()
    return (json.loads(printed.getvalue().strip().splitlines()[-1]),
            time.perf_counter() - t0)


def store_tree(root):
    """Every file of a delta store, journal entries as their arrays and
    meta without the wall-clock ``ts``."""
    from heatmap_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}
    for rel, data in read_tree(root).items():
        if rel.startswith("journal" + os.sep):
            arrays, meta = load_checkpoint(os.path.join(root, rel))
            meta.pop("ts")
            out[rel] = (json.dumps(meta, sort_keys=True),
                        {k: v.tolist() for k, v in arrays.items()})
        else:
            out[rel] = data
    return out


@contextlib.contextmanager
def timed_attr(module, name, acc):
    """Add the seconds of every call of ``module.name`` to ``acc[name]``
    (a measurement wrapper of this script, restored on exit)."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def delta_sequence(root, device, n_base, n_inc, telemetry=None):
    """The delta phase's sequence through ``cli.main`` on ``device``: a
    base, increments of seeds 1-4 (seed 4 with ``--events``,
    ``--metrics-dir`` and ``--report`` into ``telemetry`` when given),
    seed 2 again (a duplicate), a signed retraction of seed 3, a
    predicate retraction of DELTA_USER, a compaction. Each step's
    summary, seconds, segment-reduce launches and tracer spans; the
    telemetry step also its delta artifact's files (compaction prunes
    the artifact later)."""
    from heatmap_tpu_torch import analytics, synopsis
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.utils.trace import get_tracer

    dev_flag = ["--device", device]
    upd = ["update", "--journal", root, *dev_flag]
    steps = [("base", [*upd, "--input", f"synthetic:{n_base}:0"])]
    for seed in (1, 2, 3, 4):
        extra = []
        if seed == 4 and telemetry is not None:
            extra = ["--events", os.path.join(telemetry, "events.jsonl"),
                     "--metrics-dir", telemetry, "--report",
                     os.path.join(telemetry, "run_report.json")]
        steps.append((f"increment_{seed}",
                      [*upd, "--input", f"synthetic:{n_inc}:{seed}",
                       *extra]))
    steps += [
        ("duplicate_2", [*upd, "--input", f"synthetic:{n_inc}:2"]),
        ("retraction_3", [*upd, "--retractions", f"synthetic:{n_inc}:3"]),
        ("retract_user", ["retract", "--journal", root, *dev_flag,
                          "--layer", DELTA_USER]),
        ("compaction", [*upd, "--compact-after", "0"]),
    ]
    tracer = get_tracer()
    out = {}
    for name, argv in steps:
        tracer.reset()
        sp.aggregate_sorted_keys_partitioned.launches = 0
        side = {}
        with timed_attr(synopsis, "write_synopses", side), \
                timed_attr(analytics, "write_integrals", side):
            summary, seconds = cli_call(argv)
        spans = {k: v["total_s"] for k, v in tracer.report().items()}
        out[name] = {"summary": summary, "seconds": seconds,
                     "launches": sp.aggregate_sorted_keys_partitioned.launches,
                     "spans_s": spans, "side_s": side}
        if "--events" in argv:
            epoch = summary["applied"][0]["epoch"]
            out[name]["artifact"] = read_tree(
                os.path.join(root, f"delta-{epoch:06d}"))
    return out


def apply_split(rec, points):
    """Host seconds of one applied batch by part: read and hash, the
    cascade (the ``delta.compute`` span less host ingest and egress; the
    host waits on the card inside it), the artifact write (level files
    and journal entry) and the affected keys."""
    s = rec["spans_s"]
    egress = s.get("egress", 0.0) + s.get("egress.finalize", 0.0)
    ingest = s.get("ingest.batch", 0.0)
    return {"seconds": rec["seconds"], "points_per_s": points / rec["seconds"],
            "read_hash_s": s["delta.read"] + s["delta.hash"],
            "ingest_s": ingest,
            "cascade_s": s["delta.compute"] - ingest - egress,
            "write_s": egress + s["delta.journal"],
            "keys_s": s["delta.keys"], "launches": rec["launches"]}


def check_delta_sequence(seq, n_levels):
    """Launches and summaries of one sequence: 16 segment reduces per
    applied batch, none for the duplicate or the compaction."""
    for name, rec in seq.items():
        summary = rec["summary"]
        if name == "duplicate_2":
            (a,) = summary["applied"]
            assert a["duplicate"] and rec["launches"] == 0, rec
            assert a["epoch"] == seq["increment_2"]["summary"][
                "applied"][0]["epoch"], (a, seq["increment_2"])
        elif name == "retract_user":
            assert summary["rows"] > 0 and summary["batches"] == 1, summary
            assert rec["launches"] == n_levels, rec
        elif name == "compaction":
            assert summary["compaction"]["status"] == "ok", summary
            assert summary["live_deltas"] == 0 and rec["launches"] == 0, rec
        else:
            (a,) = summary["applied"]
            assert not a["duplicate"] and a["rows"] > 0, summary
            assert rec["launches"] == n_levels, (name, rec["launches"])


def assert_levels_equal(got, want, what):
    """Merged level arrays equal, level by level and column by column."""
    from heatmap_tpu_torch.io.sinks import LevelArraysSink

    assert [int(l["zoom"]) for l in got] == [int(l["zoom"]) for l in want], \
        what
    for g, w in zip(got, want):
        for k in (*LevelArraysSink.COLUMNS, "user_names", "timespan_names"):
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), \
                f"{what}: z{g['zoom']} {k}"


def write_parquet(path, cols):
    """Point columns as a Parquet file."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({
        "latitude": cols["latitude"], "longitude": cols["longitude"],
        "user_id": cols["user_id"], "source": cols["source"],
        "timestamp": np.asarray(cols["timestamp"], np.int64)}), path)


def survivors(n_base, n_inc):
    """The points a clean recompute keeps: the base and seeds 1, 2 and
    4 (seed 3 was retracted) without DELTA_USER's rows, as columns."""
    from heatmap_tpu_torch.delta import read_columns
    from heatmap_tpu_torch.io import SyntheticSource

    parts = [read_columns(SyntheticSource(n=n_base, seed=0))]
    parts += [read_columns(SyntheticSource(n=n_inc, seed=s))
              for s in (1, 2, 4)]
    out = {}
    for k in parts[0]:
        vals = [p[k] for p in parts]
        out[k] = (np.concatenate(vals) if isinstance(vals[0], np.ndarray)
                  else np.asarray(sum(vals, [])))
    keep = out["user_id"] != DELTA_USER
    return {k: v[keep] for k, v in out.items()}


def phase_delta(dev, root):
    """The delta store on the card through the ``update`` and ``retract``
    commands, as DELTA_* describe, into ``root`` (left for the ingest
    phase: a compacted base of about 1M points), with checks: (a) the compacted base
    equals one ``run --output arrays:`` over the surviving points; (b)
    the same sequence at a 100k base and 16,384-point increments writes
    equal stores on the card (with telemetry on one increment) and on
    the CPU (without); (c) 16 segment-reduce launches per applied
    batch, none for the duplicate; (d) the telemetry increment's events
    validate against EVENT_SCHEMA, metrics.prom and the report exist,
    and its delta artifact equals the same batch applied without
    telemetry. Returns the launches of the main sequence."""
    from heatmap_tpu_torch import delta, obs
    from heatmap_tpu_torch.delta.compact import drop_zero_rows
    from heatmap_tpu_torch.devices import StageTimer
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.io.merge import merge_level_dirs
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    n_levels = BatchJobConfig().cascade_config().n_levels + 1
    telemetry = os.path.join("chiprun_out", "delta_telemetry")
    shutil.rmtree(telemetry, ignore_errors=True)
    os.makedirs(telemetry)
    with tempfile.TemporaryDirectory() as tmp:
        seq = delta_sequence(root, "cuda", N_DELTA_BASE, N_DELTA_INC,
                             telemetry=telemetry)
        check_delta_sequence(seq, n_levels)
        # (a) the compacted base against one run over the survivors.
        cols = survivors(N_DELTA_BASE, N_DELTA_INC)
        pq_path = os.path.join(tmp, "survivors.parquet")
        write_parquet(pq_path, cols)
        run_dir = os.path.join(tmp, "recompute")
        _, run_s = cli_call(["run", "--input", f"parquet:{pq_path}",
                             "--output", f"arrays:{run_dir}",
                             "--device", "cuda"])
        base = delta.read_current(root)["base"]
        got = drop_zero_rows(merge_level_dirs([os.path.join(root, base)]))
        assert_levels_equal(got, merge_level_dirs([run_dir]),
                            "compacted base differs from the recompute")
        assert DELTA_USER not in set(np.asarray(got[0]["user_names"]))
        # (d) telemetry: valid events, metrics, report; the increment's
        # artifact equals the same batch applied without telemetry.
        recs = obs.read_events(os.path.join(telemetry, "events.jsonl"))
        for r in recs:
            obs.validate_event(r)
        kinds = [r["event"] for r in recs]
        assert kinds[0] == "run_start" and kinds[-1] == "run_end", kinds
        assert "delta_applied" in kinds, kinds
        assert os.path.getsize(os.path.join(telemetry, "metrics.prom"))
        assert os.path.getsize(os.path.join(telemetry, "run_report.json"))
        bare = os.path.join(tmp, "bare")
        timer = StageTimer(dev)
        res = delta.apply_batch(bare, SyntheticSource(n=N_DELTA_INC, seed=4),
                                BatchJobConfig(), device=dev, timer=timer)
        assert seq["increment_4"]["artifact"] == read_tree(
            os.path.join(bare, res.artifact)), \
            "telemetry changed the delta artifact"
        device_split_ms = {k: sum(v) for k, v in timer.ms.items()}
        # The keys as the JAX package holds them: one Python tuple each.
        t0 = time.perf_counter()
        assert len(set(res.affected_keys)) == len(res.affected_keys)
        keys_as_set_s = time.perf_counter() - t0
        # (b) the small sequence on the card (telemetry on seed 4) and on
        # the CPU (none): equal stores.
        small = {}
        for device in ("cuda", "cpu"):
            small_root = os.path.join(tmp, f"small_{device}")
            tel = os.path.join(tmp, "small_tel") if device == "cuda" else None
            if tel:
                os.makedirs(tel)
            small[device] = delta_sequence(small_root, device,
                                           N_DELTA_SMALL_BASE,
                                           N_DELTA_SMALL_INC, telemetry=tel)
        check_delta_sequence(small["cuda"], n_levels)
        assert (store_tree(os.path.join(tmp, "small_cuda"))
                == store_tree(os.path.join(tmp, "small_cpu"))), \
            "card and CPU delta stores differ"
    launches = sum(rec["launches"] for rec in seq.values())
    seq["increment_4"].pop("artifact")
    splits = {name: apply_split(rec, rec["summary"]["applied"][0]["points"])
              for name, rec in seq.items()
              if name.startswith(("base", "increment", "retraction"))}
    inc = [splits[f"increment_{s}"] for s in (1, 2, 3, 4)]
    emit({"phase": "delta", "base_points": N_DELTA_BASE,
          "increment_points": N_DELTA_INC, "launches": launches,
          "launches_by_step": {k: v["launches"] for k, v in seq.items()},
          "apply": splits,
          "increment_median_s": statistics.median(r["seconds"] for r in inc),
          "duplicate_s": seq["duplicate_2"]["seconds"],
          "retract_s": seq["retract_user"]["seconds"],
          "retract_rows": seq["retract_user"]["summary"]["rows"],
          "compaction_s": seq["compaction"]["seconds"],
          "compaction_side_s": seq["compaction"]["side_s"],
          "compaction_rows": seq["compaction"]["summary"]["compaction"][
              "rows"],
          "increment_device_split_ms": device_split_ms,
          "affected_keys": {k: v["summary"]["applied"][0]["affected_keys"]
                            for k, v in seq.items()
                            if "applied" in v["summary"]},
          "increment_keys_as_set_s": keys_as_set_s,
          "recompute_run_s": run_s, "equal_to_recompute": True,
          "small_equal_cpu": True, "telemetry_events": len(recs),
          "small_seconds": {d: sum(r["seconds"] for r in v.values())
                            for d, v in small.items()}})
    return launches


def tree_digest(root):
    """{relative path: sha256} of every file under ``root`` (a delta
    store, or a plane's ranges); journal entries (``journal/`` files) as
    their meta without the wall-clock ``ts`` and the sha256 of their
    arrays."""
    import hashlib

    from heatmap_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            h = hashlib.sha256()
            if os.path.basename(d) == "journal":
                arrays, meta = load_checkpoint(path)
                meta.pop("ts")
                h.update(json.dumps(meta, sort_keys=True).encode())
                for k in sorted(arrays):
                    h.update(k.encode())
                    h.update(np.ascontiguousarray(arrays[k]).tobytes())
            else:
                with open(path, "rb") as fh:
                    h.update(fh.read())
            out[rel] = h.hexdigest()
    return out


def ingest_drain(argv=None, library=None, digest_root=None, digest_at=(),
                 on_serve=None):
    """One drain of the ingest loop: ``cli.run_ingest_command`` on
    ``argv``, or ``ingest.run_ingest(*library)``. Returns the summary
    (or None), the IngestStats, the seconds, the flat tracer's span
    totals and, per tick as the loop measured it, its seconds, and per
    apply its seconds, points, duplicate flag and segment-reduce
    launches; and the seconds of each compaction. The loop's
    ``maybe_promote(ms=...)`` call carries each tick's seconds.
    ``digest_at`` names the points ("apply15": after the 15th apply,
    "compaction1": after the first compaction) at which the store at
    ``digest_root`` is digested mid-drain; that time is taken out of
    the tick and drain seconds. ``on_serve`` goes to
    ``run_ingest_command`` (``--serve-port`` drains)."""
    from heatmap_tpu_torch import cli, delta, ingest
    from heatmap_tpu_torch.obs import recorder
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.utils.trace import get_tracer

    agg = sp.aggregate_sorted_keys_partitioned
    applies, compactions, ticks = [], [], []
    digests, digest_s = {}, {}
    real_apply, real_compact = delta.apply_batch, delta.compact
    real_promote = recorder.maybe_promote

    def snap(label):
        if label in digest_at:
            t0 = time.perf_counter()
            digests[label] = tree_digest(digest_root)
            digest_s[len(ticks)] = time.perf_counter() - t0

    def apply(*a, **kw):
        before = agg.launches
        t0 = time.perf_counter()
        res = real_apply(*a, **kw)
        applies.append({"s": time.perf_counter() - t0, "points": res.points,
                        "duplicate": res.duplicate,
                        "launches": agg.launches - before})
        snap(f"apply{len(applies)}")
        return res

    def compact(*a, **kw):
        before = agg.launches
        t0 = time.perf_counter()
        out = real_compact(*a, **kw)
        compactions.append(time.perf_counter() - t0)
        assert agg.launches == before, "compaction launched the kernel"
        snap(f"compaction{len(compactions)}")
        return out

    def promote(*a, **kw):
        if "ms" in kw and not a:  # the tick's call, not a served request's
            ticks.append(kw["ms"] / 1e3 - digest_s.get(len(ticks), 0.0))
        return real_promote(*a, **kw)

    tracer = get_tracer()
    tracer.reset()
    delta.apply_batch, delta.compact = apply, compact
    recorder.maybe_promote = promote
    summary = None
    t0 = time.perf_counter()
    try:
        if argv is not None:
            summary, stats = cli.run_ingest_command(
                cli.build_parser().parse_args(argv), on_serve=on_serve)
        else:
            stats = ingest.run_ingest(*library[0], **library[1])
    finally:
        delta.apply_batch, delta.compact = real_apply, real_compact
        recorder.maybe_promote = real_promote
    seconds = time.perf_counter() - t0 - sum(digest_s.values())
    assert set(digests) == set(digest_at), (sorted(digests), digest_at)
    return {"summary": summary, "stats": stats, "seconds": seconds,
            "spans_s": {k: v["total_s"] for k, v in tracer.report().items()},
            "ticks_s": ticks, "applies": applies,
            "compactions_s": compactions, "digests": digests}


def check_ticks(rec, n_levels, duplicates=False):
    """Every apply of a drain: n_levels segment-reduce launches when it
    applied, none when it was a duplicate (all duplicates when asked)."""
    for a in rec["applies"]:
        assert a["duplicate"] == duplicates, a
        assert a["launches"] == (0 if duplicates else n_levels), a
    assert len(rec["ticks_s"]) == len(rec["applies"]) == rec["stats"].ticks


def drain_numbers(rec):
    """Seconds per tick (median, max; and without the compaction ticks),
    points/s, the mean split of an applied tick into spans, seconds per
    compaction, the feeder's numbers and the queue's high-water mark."""
    st = rec["stats"]
    applied = [a for a in rec["applies"] if not a["duplicate"]]
    n = max(1, len(applied))
    spans = rec["spans_s"]
    split = {k: spans.get(k, 0.0) / n for k in (
        "delta.read", "delta.hash", "cascade.bucket", "delta.compute",
        "delta.journal", "delta.keys")}
    ticks = rec["ticks_s"]
    comp = sum(rec["compactions_s"])
    split["ingest.tick"] = (sum(ticks) - comp) / n
    split["rest"] = split["ingest.tick"] - sum(
        v for k, v in split.items() if k != "ingest.tick")
    plain = sorted(ticks)[:len(ticks) - len(rec["compactions_s"])]
    return {"ticks": st.ticks, "points": st.points, "seconds": rec["seconds"],
            "tick_median_s": statistics.median(ticks),
            "tick_max_s": max(ticks),
            "tick_median_s_no_compaction": statistics.median(plain or ticks),
            "points_per_s": st.points / rec["seconds"],
            "applied_tick_split_s": split,
            "compaction_s": rec["compactions_s"],
            "feed_s": st.feed_s, "wait_s": st.feed_wait_s,
            "overlap_pct": st.feed_overlap_pct,
            "feeder_depth_hwm": st.feeder_depth_hwm,
            "max_queue_depth": st.max_queue_depth}


def pad_share(n, seed, micro, floor=1 << 12):
    """Pad lanes as a share of emissions over the drain of
    ``synthetic:n:seed`` in ``micro``-point ticks, and the pow2 buckets
    its emission counts fall into."""
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.pipeline import bucketing
    from heatmap_tpu_torch.pipeline.batch import kept_rows

    emissions, pads, buckets = 0, 0, set()
    for b in SyntheticSource(n=n, seed=seed).batches(micro):
        idx = kept_rows(b)
        e = 2 * (len(b["latitude"]) if idx is None else len(idx))
        target = bucketing.bucket_size(e, "pow2", floor)
        emissions += e
        pads += target - e
        buckets.add(target)
    return pads / emissions, buckets


def compare_base(root, run_dir):
    """The compacted base of ``root`` (no live delta) against one ``run
    --output arrays:`` of the same points, level by level."""
    from heatmap_tpu_torch import delta
    from heatmap_tpu_torch.delta.compact import drop_zero_rows
    from heatmap_tpu_torch.io.merge import merge_level_dirs

    assert not delta.live_entries(root), "deltas left live"
    base = delta.read_current(root)["base"]
    got = drop_zero_rows(merge_level_dirs([os.path.join(root, base)]))
    assert_levels_equal(got, merge_level_dirs([run_dir]),
                        f"{root}: base differs from the one-shot run")
    return sum(len(l["row"]) for l in got)


def write_valued_csv(path, n, seed):
    """``ValuedSource(n, seed)`` as a CSV with a ``value`` column."""
    with open(path, "w") as f:
        f.write("latitude,longitude,user_id,source,timestamp,value\n")
        for b in ValuedSource(n, seed).batches(1 << 20):
            f.write("".join(
                f"{a!r},{o!r},{u},{s},{t},{int(v)}\n" for a, o, u, s, t, v in
                zip(b["latitude"].tolist(), b["longitude"].tolist(),
                    b["user_id"], b["source"], b["timestamp"],
                    b["value"].tolist())))


def phase_ingest(dev, big_root):
    """The ``ingest`` command on the card, as the N_INGEST* constants
    describe: (a) a drain into a fresh journal at the command's defaults;
    (b) INGEST_B_TICKS ticks onto ``big_root`` (the delta phase's store,
    a compacted 1M-point base); (c) the replay of (a)'s first ticks onto
    a store that holds them, every tick a duplicate; (d) ``--retract``
    of (a)'s first N_INGEST_RETRACT points; (e) (a)'s first
    INGEST_CUT_TICKS ticks with every telemetry flag on, into a fresh
    journal; (f) a weighted geometric drain on the card and on the CPU.
    Checks: (a)'s compacted base equals one ``run --output arrays:`` of
    the same points; (a)'s store after its first INGEST_CUT_TICKS - 1
    ticks equals the drain of those ticks with exact padding and no
    queue or feeder; 16 segment-reduce launches per applied tick, none
    per duplicate or compaction; compile_cache misses at most the pow2
    buckets of the drain's sizes; (d)'s base equals a clean recompute of
    the surviving points; (e)'s events validate, metrics.prom carries
    the ingest and bucket series, the report its slo section, the spill
    dir is written, and its store equals (a)'s after the same ticks;
    (f)'s stores are equal. Returns (a)'s launches and (b)'s tick
    seconds."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from heatmap_tpu_torch import delta, ingest, obs
    from heatmap_tpu_torch.delta import read_columns
    from heatmap_tpu_torch.devices import StageTimer
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.pipeline import bucketing
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    device = dev.type
    n_levels = BatchJobConfig().cascade_config().n_levels + 1
    spec = f"synthetic:{N_INGEST}:{INGEST_SEED}"
    cut = INGEST_CUT_TICKS
    telemetry = os.path.join("chiprun_out", "ingest_telemetry")
    shutil.rmtree(telemetry, ignore_errors=True)
    os.makedirs(telemetry)
    out = {"phase": "ingest", "points": N_INGEST,
           "micro_batch": INGEST_MICRO}
    with tempfile.TemporaryDirectory() as tmp:
        def argv(root, source, *extra):
            return ["ingest", "--journal", os.path.join(tmp, root),
                    "--input", source, "--device", device,
                    "--micro-batch", str(INGEST_MICRO), *extra]

        # (a) the drain, its kernel launches and the process-wide
        # compile-cache mirror counted from 0; the store digested after
        # tick cut - 1 and after the first compaction (tick cut).
        bucketing.reset_cache_stats()
        sp.aggregate_sorted_keys_partitioned.launches = 0
        a = ingest_drain(argv("a", spec), digest_root=os.path.join(tmp, "a"),
                         digest_at=(f"apply{cut - 1}", "compaction1"))
        launches = sp.aggregate_sorted_keys_partitioned.launches
        check_ticks(a, n_levels)
        assert launches == n_levels * a["stats"].ticks, launches
        s_a = a["summary"]
        assert s_a["ticks"] == N_INGEST // INGEST_MICRO, s_a
        assert s_a["compactions"] == s_a["ticks"] // cut and \
            s_a["live_deltas"] == 0, s_a
        share, buckets = pad_share(N_INGEST, INGEST_SEED, INGEST_MICRO)
        assert s_a["compile_cache"]["misses"] <= len(buckets), \
            (s_a["compile_cache"], buckets)
        run_dir = os.path.join(tmp, "run_a")
        _, run_s = cli_call(["run", "--input", spec, "--output",
                             f"arrays:{run_dir}", "--device", device])
        rows = compare_base(os.path.join(tmp, "a"), run_dir)
        shutil.rmtree(run_dir)
        # The first cut - 1 ticks with exact padding, synchronously, no
        # feeder; then (c), their replay: every tick a duplicate.
        exact = ingest_drain(library=(
            (os.path.join(tmp, "exact"),
             SyntheticSource(n=N_INGEST, seed=INGEST_SEED),
             BatchJobConfig(pad_bucketing="exact")),
            {"ingest": ingest.IngestConfig(micro_batch=INGEST_MICRO,
                                           queue_depth=None, feed_depth=0,
                                           max_ticks=cut - 1),
             "device": dev}))
        check_ticks(exact, n_levels)
        assert tree_digest(os.path.join(tmp, "exact")) == \
            a["digests"][f"apply{cut - 1}"], \
            "exact synchronous drain differs from the padded fed drain"
        c = ingest_drain(argv("exact", spec, "--max-ticks", str(cut - 1)))
        check_ticks(c, n_levels, duplicates=True)
        assert c["summary"]["duplicates"] == c["summary"]["ticks"] == \
            cut - 1, c["summary"]
        shutil.rmtree(os.path.join(tmp, "exact"))
        # (d) retract the first N_INGEST_RETRACT points (a synthetic
        # source of a multiple of its 65,536-point chunk is a prefix of
        # a longer one of the same seed).
        d = ingest_drain(argv("a", f"synthetic:{N_INGEST_RETRACT}:"
                              f"{INGEST_SEED}", "--retract"))
        check_ticks(d, n_levels)
        assert d["summary"]["live_deltas"] == 0, d["summary"]
        cols = read_columns(SyntheticSource(n=N_INGEST, seed=INGEST_SEED))
        keep = slice(N_INGEST_RETRACT, None)
        pq_path = os.path.join(tmp, "survivors.parquet")
        pq.write_table(pa.table({
            "latitude": cols["latitude"][keep],
            "longitude": cols["longitude"][keep],
            "user_id": cols["user_id"][keep], "source": cols["source"][keep],
            "timestamp": np.asarray(cols["timestamp"][keep], np.int64)}),
            pq_path)
        del cols
        run_dir = os.path.join(tmp, "run_d")
        cli_call(["run", "--input", f"parquet:{pq_path}", "--output",
                  f"arrays:{run_dir}", "--device", device])
        compare_base(os.path.join(tmp, "a"), run_dir)
        shutil.rmtree(os.path.join(tmp, "a"))
        shutil.rmtree(run_dir)
        # (e) (a)'s first ticks, through the first compaction, with
        # every telemetry flag on.
        e = ingest_drain(argv(
            "e", spec, "--max-ticks", str(cut),
            "--events", os.path.join(telemetry, "events.jsonl"),
            "--metrics-dir", telemetry,
            "--report", os.path.join(telemetry, "run_report.json"),
            "--slo", "fresh:staleness:max_age_s=30",
            "--incident-dir", os.path.join(telemetry, "incidents"),
            "--flight-recorder-spans", "256", "--tail-latency-ms", "1",
            "--telemetry-sample-interval", "0.5",
            "--watch", "ingest_lag_seconds:z=6"))
        check_ticks(e, n_levels)
        assert tree_digest(os.path.join(tmp, "e")) == \
            a["digests"]["compaction1"], "telemetry changed the ingest store"
        shutil.rmtree(os.path.join(tmp, "e"))
        recs = obs.read_events(os.path.join(telemetry, "events.jsonl"))
        for r in recs:
            obs.validate_event(r)
        kinds = [r["event"] for r in recs]
        assert kinds[0] == "run_start" and kinds[-1] == "run_end", kinds[:3]
        lags = [r["lag_s"] for r in recs if r["event"] == "ingest_tick"]
        assert len(lags) == cut, len(lags)
        with open(os.path.join(telemetry, "metrics.prom")) as f:
            prom = f.read()
        # (a) made every signature of the mirror, so (e)'s dispatches
        # all count as hits.
        for series in ("ingest_ticks_total", "ingest_lag_seconds",
                       "ingest_tick_seconds", "cascade_bucket_hits_total",
                       "cascade_pad_emissions_total"):
            assert series in prom, series
        with open(os.path.join(telemetry, "run_report.json")) as f:
            report = json.load(f)
        assert report["slo"]["objectives"][0]["name"] == "fresh", report
        spill = os.path.join(telemetry, "incidents", "telemetry")
        assert any(x.startswith("snap-") for x in os.listdir(spill))
        pads_counted = [float(line.split()[-1]) for line in prom.splitlines()
                        if line.startswith("cascade_pad_emissions_total")]
        # (b) ticks onto the delta phase's store (1M-point base).
        b = ingest_drain(argv(big_root, f"synthetic:"
                              f"{INGEST_B_TICKS * INGEST_MICRO}:8",
                              "--max-ticks", str(INGEST_B_TICKS),
                              "--compact-every", "0"))
        check_ticks(b, n_levels)
        # One tick's cascade split on the card (fenced stages).
        timer = StageTimer(dev)
        delta.apply_batch(os.path.join(tmp, "split"),
                          SyntheticSource(n=INGEST_MICRO, seed=9),
                          BatchJobConfig(pad_bucketing="pow2"), device=dev,
                          timer=timer)
        tick_device_ms = {k: sum(v) for k, v in timer.ms.items()}
        # (f) weighted, geometric padding, card and CPU.
        csv_path = os.path.join(tmp, "valued.csv")
        write_valued_csv(csv_path, N_INGEST_WEIGHTED, 11)
        f_s = {}
        for dv in (device, "cpu"):
            rec = ingest_drain(["ingest", "--journal",
                                os.path.join(tmp, f"f_{dv}"), "--input",
                                f"csv:{csv_path}", "--device", dv,
                                "--weighted", "--pad-bucketing", "geometric"])
            f_s[dv] = rec["seconds"]
        assert tree_digest(os.path.join(tmp, f"f_{device}")) == \
            tree_digest(os.path.join(tmp, "f_cpu")), \
            "weighted card and CPU stores differ"
    out.update({
        "launches": launches,
        "launches_per_applied_tick": n_levels,
        "a": drain_numbers(a), "b": drain_numbers(b),
        "c": drain_numbers(c), "d": drain_numbers(d), "e": drain_numbers(e),
        "a_compile_cache": s_a["compile_cache"],
        "pow2_buckets": sorted(buckets), "pad_share": share,
        "pad_lanes_counted_e": pads_counted,
        "exact_sync_seconds": exact["seconds"],
        "exact_sync_tick_median_s": statistics.median(exact["ticks_s"]),
        "padded_fed_first_ticks_median_s": statistics.median(
            a["ticks_s"][:cut - 1]),
        "base_rows_a": rows, "run_arrays_s": run_s,
        "ingest_lag_median_s": statistics.median(lags),
        "telemetry_cost_first_ticks_s": {"off": sum(a["ticks_s"][:cut]),
                                         "on": sum(e["ticks_s"])},
        "telemetry_events": len(recs),
        "tick_device_split_ms": tick_device_ms,
        "weighted_seconds": f_s,
        "equal_to_run": True, "equal_exact_sync": True,
        "retract_equal_recompute": True, "telemetry_store_equal": True,
        "weighted_card_equal_cpu": True,
    })
    emit(out)
    return launches, b["ticks_s"]


def serve_tile_list(store, n_full, n_empty, zooms, seed):
    """The serve phase's fixed list: the ``n_full`` most populated tiles
    over ``zooms`` of the all/alltime layer (an equal share per zoom,
    the rest to the lowest zooms; population = the sum of the tile's
    detail cells), then ``n_empty`` tiles of those zooms with no data.
    Returns [(z, x, y, total)]; total 0.0 marks an empty tile."""
    from heatmap_tpu_torch.tilemath.morton import (morton_decode_np,
                                                   morton_encode_np)

    layer = store.layer("all|alltime")
    rd = layer.result_delta
    share, extra = divmod(n_full, len(zooms))
    full, seen = [], {}
    for i, z in enumerate(zooms):
        level = layer.levels[z + rd]
        tiles, inv = np.unique(np.asarray(level.codes) >> (2 * rd),
                               return_inverse=True)
        sums = np.bincount(inv, weights=np.asarray(level.values))
        top = np.argsort(-sums, kind="stable")[:share + (i < extra)]
        r, c = morton_decode_np(tiles[top])
        full += [(z, int(x), int(y), float(v))
                 for x, y, v in zip(c.tolist(), r.tolist(), sums[top])]
        seen[z] = set(tiles.tolist())
    rng = np.random.default_rng(seed)
    empty = []
    while len(empty) < n_empty:
        z = int(zooms[len(empty) % len(zooms)])
        x, y = (int(v) for v in rng.integers(0, 1 << z, 2))
        code = int(morton_encode_np(np.int64(y), np.int64(x)))
        if code not in seen[z] and (z, x, y, 0.0) not in empty:
            empty.append((z, x, y, 0.0))
    return full + empty


def tile_paths(tiles, layer="all%7Calltime"):
    return [f"/tiles/{layer}/{z}/{x}/{y}.{fmt}"
            for z, x, y, _ in tiles for fmt in ("png", "json")]


def fetch(base, paths):
    """GET every path once over one keep-alive connection: (latencies in
    s, {path: (status, etag, body)})."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlsplit(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    lat, got = [], {}
    try:
        for p in paths:
            t0 = time.perf_counter()
            conn.request("GET", p)
            r = conn.getresponse()
            body = r.read()
            lat.append(time.perf_counter() - t0)
            got[p] = (r.status, r.getheader("ETag"), body)
    finally:
        conn.close()
    return lat, got


def paced_client(base, paths, stop, client, gate):
    """Cycle over ``paths`` on one keep-alive connection until ``stop``
    is set, at ``client["rps"]`` requests a second (0 pauses; None goes
    as fast as the connection does), each request under the lock
    ``gate``; appends (``client["tick"]``, rate, seconds) of each request
    to ``client["log"]``."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlsplit(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    i = 0
    try:
        while not stop.is_set():
            rps = client["rps"]
            if rps == 0:
                stop.wait(0.05)
                continue
            with gate:
                t0 = time.perf_counter()
                conn.request("GET", paths[i % len(paths)])
                conn.getresponse().read()
                dt = time.perf_counter() - t0
            client["log"].append((client["tick"], rps, dt))
            i += 1
            if rps is not None:
                stop.wait(max(1.0 / rps - dt, 0.0))
    finally:
        conn.close()


def pct_ms(lat):
    a = np.asarray(lat) * 1e3
    if not len(a):
        return {"n": 0}
    return {"n": len(a), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max())}


def check_tiles(tiles, got):
    """Populated tiles answer 200 with a JSON body whose values sum to
    the tile's total and a PNG; empty ones 404."""
    for z, x, y, total in tiles:
        js = got[f"/tiles/all%7Calltime/{z}/{x}/{y}.json"]
        png = got[f"/tiles/all%7Calltime/{z}/{x}/{y}.png"]
        if total == 0.0:
            assert js[0] == png[0] == 404, (z, x, y, js[0], png[0])
            continue
        assert js[0] == png[0] == 200, (z, x, y, js[0], png[0])
        assert png[2].startswith(b"\x89PNG"), (z, x, y)
        assert math.isclose(sum(json.loads(js[2]).values()), total,
                            rel_tol=1e-12), (z, x, y)


def cold_index(spec):
    """A cold mount for the stale checks: the tile index a ``TileStore``
    over ``spec`` builds, without its synopsis and integral views, which
    plain tile requests do not read."""
    from heatmap_tpu_torch.serve import TileStore

    class TileIndex(TileStore):
        def _attach_synopses(self, *a):
            pass

        def _attach_integrals(self, *a):
            pass

    return TileIndex(spec)


def served_drain(root, spec, rates, device, tiles_of, cold_every_tick):
    """``ingest --serve-port 0`` at the command's defaults (INGEST_MICRO
    is its ``--micro-batch``) onto the store at ``root``: one tick of
    ``spec``'s INGEST_MICRO-point batches per
    entry of ``rates``, while a client thread fetches the tiles
    ``tiles_of(app, base_url)`` names at tick k's entry of ``rates`` requests a
    second (``paced_client``). ``tiles_of`` runs once the server is up,
    before the first tick. After every applied tick, with the client
    held: each tile cached before or after the refresh that the tick
    touched, and each such JSON tile, re-fetched over HTTP equals the live index's uncached answer
    (status, body, ETag), and a cold mount's (``cold_index``) after
    every tick when ``cold_every_tick``, else after the last. All ticks'
    batches are queued before the first tick (at most the default
    queue's 4), so a tick's lag less the checks so far is its lag
    without them. Returns the drain record (``ingest_drain``) with the
    launches, the tile list and, per tick, its figures."""
    import threading
    import urllib.parse

    from heatmap_tpu_torch import delta, obs
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.serve import ServeApp, TileCache

    assert 1 <= len(rates) <= 4, rates
    events = root + ".serve_events.jsonl"
    stop, gate = threading.Event(), threading.Lock()
    client = {"rps": rates[0], "tick": 0, "log": []}
    per = {"refresh_s": [], "dropped": [], "checked": [], "check_s": []}
    state = {}
    real_refresh = delta.refresh_serving

    def on_serve(app, base_url):
        state["base"] = base_url
        state["tiles"] = tiles_of(app, base_url)
        state["thread"] = threading.Thread(
            target=paced_client, daemon=True,
            args=(base_url, tile_paths(state["tiles"]), stop, client, gate))
        state["thread"].start()

    def refresh(result, store, cache=None):
        before = list(cache._entries)
        t0 = time.perf_counter()
        n = real_refresh(result, store, cache)
        per["refresh_s"].append(time.perf_counter() - t0)
        per["dropped"].append(n)
        tick = len(per["refresh_s"])
        with gate:
            t0 = time.perf_counter()
            keys = [k for k in dict.fromkeys(before + list(cache._entries))
                    if len(k) == 5 and (k in result.affected_keys
                                        or k[4] == "json")]
            paths = [f"/tiles/{urllib.parse.quote(k[0], safe='')}/"
                     f"{k[1]}/{k[2]}/{k[3]}.{k[4]}" for k in keys]
            _, live = fetch(state["base"], paths)
            apps = [ServeApp(store, TileCache())]
            if cold_every_tick or tick == len(rates):
                apps.append(ServeApp(cold_index(f"delta:{root}"),
                                     TileCache()))
            for p in paths:
                for app in apps:
                    want = app.handle("GET", p)
                    assert live[p] == (want[0], want[3], want[2]), \
                        f"stale tile after tick {tick}: {p}"
            per["checked"].append(len(paths))
            per["check_s"].append(time.perf_counter() - t0)
            client["tick"] = tick
            client["rps"] = rates[min(tick, len(rates) - 1)]
        return n

    delta.refresh_serving = refresh
    sp.aggregate_sorted_keys_partitioned.launches = 0
    try:
        rec = ingest_drain(["ingest", "--journal", root, "--input", spec,
                            "--device", device, "--serve-port", "0",
                            "--micro-batch", str(INGEST_MICRO),
                            "--events", events], on_serve=on_serve)
    finally:
        delta.refresh_serving = real_refresh
        stop.set()
    rec["launches"] = sp.aggregate_sorted_keys_partitioned.launches
    state["thread"].join(60)
    assert rec["stats"].ticks == len(rates) == len(per["refresh_s"]), \
        (rec["stats"].ticks, len(per["refresh_s"]))
    lags = [r["lag_s"] for r in obs.read_events(events)
            if r["event"] == "ingest_tick"]
    rec["tiles"] = state["tiles"]
    rec["per_tick"] = [{
        "client_rps": rates[i],
        "tick_s": rec["ticks_s"][i] - per["check_s"][i],
        "refresh_serving_s": per["refresh_s"][i],
        "entries_dropped": per["dropped"][i],
        "ingest_lag_s": lags[i] - sum(per["check_s"][:i + 1]),
        "tiles_during_tick": pct_ms([s for t, _, s in client["log"]
                                     if t == i]),
        "stale_check": {"tiles": per["checked"][i],
                        "seconds": per["check_s"][i]},
    } for i in range(len(rates))]
    return rec


def phase_serve(dev, big_root, plain_ticks_s):
    """Serving on the card's stores, as SERVE_* describe. (a) and (b):
    ``ingest --serve-port 0`` at its defaults onto the delta phase's
    store (``big_root``): its mount of ``delta:``, the tile list fetched
    cold then warm before the first tick (equal answers, each tile's
    JSON summing to its total), then one tick per SERVE_CLIENT_RPS entry
    with the stale checks of ``served_drain`` (a cold mount after the
    last tick); 16 segment-reduce launches per applied tick; the store
    equal to the same drain on the CPU. ``plain_ticks_s`` are the ingest
    phase's ticks onto that store without serving. The small-store
    case: the same onto a fresh compacted N_SERVE_BASE-point base, one
    tick per SERVE_CURVE_RPS entry, a cold mount after every tick, the
    store equal to the same drain without serving. (c) ``serve
    --follow-stream`` at its defaults with ``--tick-seconds 0`` for
    SERVE_TICKS ticks over the small store: one window-histogram launch
    a tick, the live raster bit-equal to the port's HeatmapStream on the
    CPU over the same points. Returns the segment-reduce launches of the
    served ticks and (c)'s histogram launches."""
    import threading

    from heatmap_tpu_torch import cli, delta
    from heatmap_tpu_torch.io import open_source
    from heatmap_tpu_torch.ops.histogram import window_from_bounds
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig, load_columns
    from heatmap_tpu_torch.serve import LiveLayer
    from heatmap_tpu_torch.streaming import HeatmapStream

    device = dev.type
    n_levels = BatchJobConfig().cascade_config().n_levels + 1
    out = {"phase": "serve"}

    def ticks_summary(rec, plain_s):
        served = [t["tick_s"] for t in rec["per_tick"]]
        return {"ticks": len(served), "launches": rec["launches"],
                "launches_per_applied_tick": n_levels,
                "per_tick": rec["per_tick"],
                "tick_s_plain": {"median": statistics.median(plain_s),
                                 "max": max(plain_s)}}

    with tempfile.TemporaryDirectory() as tmp:
        # (a) and (b) on the delta phase's store; a copy for the CPU.
        cpu_root = os.path.join(tmp, "big_cpu")
        shutil.copytree(big_root, cpu_root)
        spec = f"synthetic:{len(SERVE_CLIENT_RPS) * INGEST_MICRO}:22"
        a = {"live_deltas": len(delta.live_entries(big_root))}
        t_start = time.perf_counter()

        def cold_then_warm(app, base_url):
            a["mount_s"] = time.perf_counter() - t_start
            store = app.store
            a["store_rows"] = int(sum(
                len(lv) for name, layer in store.layers.items()
                if name != "default" for lv in layer.levels.values()))
            tiles = serve_tile_list(store, SERVE_TILES, SERVE_EMPTY,
                                    SERVE_ZOOMS, 1)
            paths = tile_paths(tiles)
            t0 = time.perf_counter()
            cold_lat, cold = fetch(base_url, paths)
            cold_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            warm_lat, warm = fetch(base_url, paths)
            warm_s = time.perf_counter() - t0
            assert warm == cold, "warm answers differ from cold"
            check_tiles(tiles, cold)
            a.update({
                "requests": len(paths),
                "cold": {**pct_ms(cold_lat),
                         "requests_per_s": len(paths) / cold_s},
                "warm": {**pct_ms(warm_lat),
                         "requests_per_s": len(paths) / warm_s},
                "cache_entries": len(app.cache),
                "cache_bytes": app.cache.nbytes})
            return tiles

        big = served_drain(big_root, spec, SERVE_CLIENT_RPS, device,
                           cold_then_warm, cold_every_tick=False)
        check_ticks(big, n_levels)
        assert big["launches"] == n_levels * len(SERVE_CLIENT_RPS), \
            big["launches"]
        cpu = ingest_drain(["ingest", "--journal", cpu_root, "--input",
                            spec, "--device", "cpu", "--micro-batch",
                            str(INGEST_MICRO)])
        assert tree_digest(big_root) == tree_digest(cpu_root), \
            "card and CPU ingest stores differ"
        shutil.rmtree(cpu_root)
        out["a"] = a
        out["b"] = {**ticks_summary(big, plain_ticks_s),
                    "tick_s_cpu_median": statistics.median(cpu["ticks_s"]),
                    "equal_cpu": True}
        launches = big["launches"]
        del big, cpu
        gc.collect()

        # The small-store case: one tick per client rate.
        roots = {k: os.path.join(tmp, k) for k in ("serve", "plain")}
        cli_call(["update", "--journal", roots["serve"], "--input",
                  f"synthetic:{N_SERVE_BASE}:21", "--compact-after", "0",
                  "--device", device])
        shutil.copytree(roots["serve"], roots["plain"])
        spec = f"synthetic:{len(SERVE_CURVE_RPS) * INGEST_MICRO}:22"
        def warm_list(app, base_url):
            # Fetched once, so the first tick finds the cache filled.
            tiles = serve_tile_list(app.store, 200, 20, SERVE_ZOOMS, 2)
            fetch(base_url, tile_paths(tiles))
            return tiles

        small = served_drain(roots["serve"], spec, SERVE_CURVE_RPS, device,
                             warm_list, cold_every_tick=True)
        check_ticks(small, n_levels)
        assert small["launches"] == n_levels * len(SERVE_CURVE_RPS), \
            small["launches"]
        plain = ingest_drain(["ingest", "--journal", roots["plain"],
                              "--input", spec, "--device", device,
                              "--micro-batch", str(INGEST_MICRO)])
        check_ticks(plain, n_levels)
        assert tree_digest(roots["serve"]) == tree_digest(roots["plain"]), \
            "serving changed the ingest store"
        out["b_small_store"] = {**ticks_summary(small, plain["ticks_s"]),
                                "base_points": N_SERVE_BASE,
                                "equal_plain": True}
        launches += small["launches"]

        # (c) serve --follow-stream at its defaults.
        follow = f"synthetic:{SERVE_TICKS * STREAM_BATCH}:23"
        args = cli.build_parser().parse_args(
            ["serve", "--store", f"delta:{roots['serve']}", "--port", "0",
             "--follow-stream", follow, "--tick-seconds", "0",
             "--batch-points", str(STREAM_BATCH), "--device", device])
        tick_s = []
        real_tick = LiveLayer.tick

        def tick(self, *a, **kw):
            t0 = time.perf_counter()
            keys = real_tick(self, *a, **kw)
            tick_s.append(time.perf_counter() - t0)
            return keys

        zero_window_counters()
        LiveLayer.tick = tick
        try:
            handle = cli.start_serve(args)
            handle.live.thread.join(300)
            assert not handle.live.thread.is_alive(), "follow-stream hung"
        finally:
            LiveLayer.tick = real_tick
        hist = window_counters()["window_histogram"]
        try:
            assert handle.live.ticks == SERVE_TICKS == hist, \
                (handle.live.ticks, hist)
            layer = handle.live.layer
            got = layer.stream.snapshot()
            cpu_stream = HeatmapStream(layer.stream.config, device="cpu")
            t = 0.0
            for batch in open_source(follow, read_value=False).batches(
                    args.batch_points):
                cols = load_columns(batch)
                t += args.interval
                cpu_stream.update(cols["latitude"], cols["longitude"], t)
            want = cpu_stream.snapshot()
            assert got.shape == want.shape and np.array_equal(got, want), \
                "live raster differs from the CPU stream's"
            assert layer.window == window_from_bounds(
                (args.lat_min, args.lat_max), (args.lon_min, args.lon_max),
                zoom=args.zoom)
            server = handle.server
            threading.Thread(target=server.serve_forever, daemon=True).start()
            rows, cols = np.nonzero(want)
            rows = rows + layer.window.row0
            cols = cols + layer.window.col0
            live_tiles = []
            for z in (6, 7, 8):  # a rollup, the stored zoom, an upsample
                shift = args.zoom - z
                live_tiles += [(z, int(x), int(y), 0.0) for x, y in set(
                    zip((cols >> shift).tolist(), (rows >> shift).tolist()))]
            _, live = fetch(handle.banner["serving"],
                            tile_paths(live_tiles, "live"))
            assert all(v[0] == 200 for v in live.values()), "live 404"
            server.shutdown()
        finally:
            handle.close()
        out["c"] = {"ticks": handle.live.ticks, "launches": hist,
                    "window": [layer.window.height, layer.window.width],
                    "tick_ms": {"median": statistics.median(tick_s) * 1e3,
                                "max": max(tick_s) * 1e3},
                    "live_tiles_fetched": len(live),
                    "raster_equal_cpu": True}
    emit(out)
    return launches, hist


def plane_digest(root):
    """What a drain determines under a write-plane root: the range
    stores' ``tree_digest``, the ledger's batches as a sorted list, and
    the pointed manifest's plan, order and ranges. An earlier manifest
    records whichever sub-applies had landed when a batch finished, and
    ledger epochs follow completion order: both vary with the pumps'
    timing."""
    from heatmap_tpu_torch.utils.checkpoint import load_checkpoint
    from heatmap_tpu_torch.writeplane import read_manifest

    out = tree_digest(os.path.join(root, "ranges"))
    ledger = set()
    ldir = os.path.join(root, "ledger")
    for f in os.listdir(ldir):
        if f.startswith("ckpt-"):
            meta = load_checkpoint(os.path.join(ldir, f))[1]
            ledger.add((meta["content_hash"], meta["points"], meta["sign"]))
    out["ledger"] = sorted(ledger)
    snap = read_manifest(root)
    out["manifest"] = {k: snap[k] for k in ("plan", "order", "ranges")}
    return out


def plane_levels(root):
    """The merged level arrays a ``writeplane:`` reader of the newest
    manifest serves (zero rows dropped, as the store drops them)."""
    from heatmap_tpu_torch.delta.compact import drop_zero_rows
    from heatmap_tpu_torch.io.merge import merge_level_dirs
    from heatmap_tpu_torch.writeplane import overlay_dirs, read_manifest

    return drop_zero_rows(merge_level_dirs(
        overlay_dirs(root, read_manifest(root))))


def one_shot_levels(tmp, name, spec, device):
    """One ``run --output arrays:`` of ``spec``: its level arrays and
    seconds."""
    from heatmap_tpu_torch.io.merge import merge_level_dirs

    run_dir = os.path.join(tmp, name)
    _, seconds = cli_call(["run", "--input", spec, "--output",
                           f"arrays:{run_dir}", "--device", device])
    return merge_level_dirs([run_dir]), seconds


def plane_drain(argv):
    """One ``writeplane`` command through ``cli.main``: its summary and
    seconds, the segment-reduce launches (set to 0 just before), each
    sub-apply's range, seconds and duplicate flag, each compaction's
    seconds, and the sub-batches the ranges' journals record as applied
    (each range journal's newest epoch; pruning keeps the numbering)."""
    import threading

    from heatmap_tpu_torch.delta import DeltaJournal
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.writeplane import WritePlane, range_root, \
        read_manifest

    root = argv[argv.index("--root") + 1]
    applies, compactions = [], []
    lock = threading.Lock()
    real_apply, real_compact = WritePlane.apply_range, WritePlane.compact_range

    def apply_range(self, name, *a, **kw):
        t0 = time.perf_counter()
        res = real_apply(self, name, *a, **kw)
        with lock:
            applies.append({"range": name, "s": time.perf_counter() - t0,
                            "duplicate": res.duplicate})
        return res

    def compact_range(self, *a, **kw):
        t0 = time.perf_counter()
        out = real_compact(self, *a, **kw)
        with lock:
            compactions.append(time.perf_counter() - t0)
        return out

    WritePlane.apply_range, WritePlane.compact_range = apply_range, \
        compact_range
    sp.aggregate_sorted_keys_partitioned.launches = 0
    try:
        summary, seconds = cli_call(argv)
    finally:
        WritePlane.apply_range, WritePlane.compact_range = real_apply, \
            real_compact
    launches = sp.aggregate_sorted_keys_partitioned.launches
    snap = read_manifest(root)
    journaled = {name: DeltaJournal(os.path.join(range_root(root, name),
                                                 "journal")).latest_epoch()
                 for name in snap["order"]}
    return {"summary": summary, "seconds": seconds, "launches": launches,
            "applies": applies, "compactions_s": compactions,
            "journaled": journaled}


def plane_numbers(rec):
    """points/s, the lag median, sub-apply seconds and compactions of one
    drain's first run."""
    run = rec["summary"]["runs"][0]
    applied = [a["s"] for a in rec["applies"] if not a["duplicate"]]
    by_range = {}
    for a in rec["applies"]:
        if not a["duplicate"]:
            by_range.setdefault(a["range"], []).append(a["s"])
    return {"batches": run["batches"], "points": run["points"],
            "seconds": rec["seconds"],
            "points_per_s": run["points"] / rec["seconds"],
            "lag_p50_s": run["lag_p50_s"],
            "sub_applies": len(applied),
            "sub_apply_median_s": (statistics.median(applied)
                                   if applied else None),
            "sub_apply_median_s_by_range": {
                k: statistics.median(v) for k, v in sorted(by_range.items())},
            "compaction_s": rec["compactions_s"],
            "launches": rec["launches"], "ranges": rec["summary"]["ranges"]}


def phase_writeplane(dev, tmp):
    """The ``writeplane`` command on the card (pump threads launching the
    cascade concurrently), as the N_WRITEPLANE* constants describe, with
    checks: (a) a ``writeplane:`` store over the drain serves levels
    byte-equal to one ``run`` over the same points, and the same drain
    with ``--pad-bucketing exact`` serves the same; 16 segment reduces
    per sub-batch the ranges' journals record as applied, counted over
    both pump threads; (b) a replay of (a): every batch a ledger
    duplicate, no launch, the range trees unchanged; (c) 4 writers, a
    retraction of the first N_WRITEPLANE_RETRACT points and a rebalance
    serve a one-shot run over the surviving points; (d) (a)'s first
    WRITEPLANE_CUT_TICKS batches on the card and on the CPU give equal
    range trees. Then (a)'s first WRITEPLANE_CURVE_TICKS batches at each
    writer count of WRITEPLANE_WRITERS. Returns (a)'s root (the fleet
    phase serves it) and the launches of the card's drains."""
    from heatmap_tpu_torch import serve as serve_mod
    from heatmap_tpu_torch.delta import read_columns
    from heatmap_tpu_torch.io import SyntheticSource
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    t_phase = time.perf_counter()
    n_levels = BatchJobConfig().cascade_config().n_levels + 1
    spec = f"synthetic:{N_WRITEPLANE}:7"
    batches = N_WRITEPLANE // INGEST_MICRO

    def wp(root, *extra, device="cuda"):
        # INGEST_MICRO is the command's default --micro-batch.
        return ["writeplane", "--root", root, "--device", device,
                "--micro-batch", str(INGEST_MICRO), *extra]

    def check_launches(rec, what):
        applied = sum(not a["duplicate"] for a in rec["applies"])
        assert applied == sum(rec["journaled"].values()), \
            (what, applied, rec["journaled"])
        assert rec["launches"] == n_levels * applied, \
            (what, rec["launches"], applied)
        assert len({a["range"] for a in rec["applies"]}) == len(
            rec["summary"]["ranges"]), what
        return applied

    out = {"phase": "writeplane", "micro_batch": INGEST_MICRO,
           "launches_per_applied_sub_batch": n_levels}
    launches = 0
    # (a) the default drain, its one-shot run and the exact-padded drain.
    root_a = os.path.join(tmp, "plane_a")
    a = plane_drain(wp(root_a, "--input", spec))
    run = a["summary"]["runs"][0]
    assert run["batches"] == run["completed"] == batches, run
    assert run["failed"] == 0 and run["points"] == N_WRITEPLANE, run
    applied_a = check_launches(a, "a")
    assert a["compactions_s"], "no range compacted"
    launches += a["launches"]
    want, run_s = one_shot_levels(tmp, "oneshot_a", spec, "cuda")
    got = plane_levels(root_a)
    assert_levels_equal(got, want, "plane (a) against the one-shot run")
    store = serve_mod.TileStore(f"writeplane:{root_a}")
    assert store.kind == "writeplane"
    assert store.delta_epoch == a["summary"]["epoch"]
    del store
    exact = plane_drain(wp(os.path.join(tmp, "plane_exact"), "--input",
                           spec, "--pad-bucketing", "exact"))
    check_launches(exact, "exact")
    launches += exact["launches"]
    assert_levels_equal(plane_levels(os.path.join(tmp, "plane_exact")), got,
                        "exact-padded plane against the pow2 plane")
    shutil.rmtree(os.path.join(tmp, "plane_exact"))
    out["a"] = {**plane_numbers(a), "applied_sub_batches": applied_a,
                "journaled": a["journaled"], "one_shot_run_s": run_s,
                "equal_one_shot": True, "equal_exact_padding": True,
                "exact_points_per_s": N_WRITEPLANE / exact["seconds"],
                "exact_sub_apply_median_s": plane_numbers(exact)[
                    "sub_apply_median_s"]}
    # (b) the replay: all ledger duplicates, nothing launched or written.
    before = plane_digest(root_a)
    b = plane_drain(wp(root_a, "--input", spec))
    run = b["summary"]["runs"][0]
    assert run["duplicates"] == run["batches"] == batches, run
    assert b["launches"] == 0 and not b["applies"], b["launches"]
    assert plane_digest(root_a) == before, "the replay changed the plane"
    out["b"] = {"batches": run["batches"], "duplicates": run["duplicates"],
                "seconds": b["seconds"], "launches": 0,
                "tree_unchanged": True}
    # (c) 4 writers, a retraction of the first points, a rebalance.
    cols = read_columns(SyntheticSource(n=N_WRITEPLANE_C, seed=11))
    head = {k: v[:N_WRITEPLANE_RETRACT] for k, v in cols.items()}
    tail = {k: v[N_WRITEPLANE_RETRACT:] for k, v in cols.items()}
    retract_pq = os.path.join(tmp, "retract.parquet")
    survivors_pq = os.path.join(tmp, "survivors.parquet")
    write_parquet(retract_pq, head)
    write_parquet(survivors_pq, tail)
    root_c = os.path.join(tmp, "plane_c")
    c = plane_drain(wp(root_c, "--writers", "4", "--input",
                       f"synthetic:{N_WRITEPLANE_C}:11", "--retractions",
                       f"parquet:{retract_pq}", "--rebalance"))
    for run in c["summary"]["runs"]:
        assert run["failed"] == 0 and run["completed"] == run["batches"], run
    check_launches(c, "c")
    launches += c["launches"]
    want_c, _ = one_shot_levels(tmp, "oneshot_c", f"parquet:{survivors_pq}",
                                "cuda")
    assert_levels_equal(plane_levels(root_c), want_c,
                        "plane (c) against the one-shot run of survivors")
    shutil.rmtree(root_c)
    out["c"] = {**plane_numbers(c), "writers": 4,
                "retracted_points": N_WRITEPLANE_RETRACT,
                "retract_run": c["summary"]["runs"][1],
                "rebalance": c["summary"].get("rebalance"),
                "ranges": c["summary"]["ranges"],
                "equal_one_shot_survivors": True}
    # (d) the first batches on the card and on the CPU.
    cut = ["--input", spec, "--max-ticks", str(WRITEPLANE_CUT_TICKS)]
    digests = {}
    for device in ("cuda", "cpu"):
        root_d = os.path.join(tmp, f"plane_d_{device}")
        d = plane_drain(wp(root_d, *cut, device=device))
        if device == "cuda":
            check_launches(d, "d")
            launches += d["launches"]
        digests[device] = plane_digest(root_d)
        out.setdefault("d", {})[f"{device}_s"] = d["seconds"]
        shutil.rmtree(root_d)
    assert digests["cuda"] == digests["cpu"], \
        "card and CPU write planes differ"
    out["d"]["equal_cpu"] = True
    # The writer curve: the same batches at 1, 2 and 4 writers.
    curve = {}
    for writers in WRITEPLANE_WRITERS:
        root_w = os.path.join(tmp, f"plane_w{writers}")
        w = plane_drain(wp(root_w, "--writers", str(writers), "--input",
                           spec, "--max-ticks",
                           str(WRITEPLANE_CURVE_TICKS)))
        check_launches(w, f"writers {writers}")
        launches += w["launches"]
        curve[writers] = plane_numbers(w)
        shutil.rmtree(root_w)
    out["writers"] = curve
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return root_a, launches


def child_pids(pid):
    """The pids whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return sorted(out)


def start_seconds(pid):
    """A process's start, in seconds since boot (/proc/PID/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def uptime_s():
    with open("/proc/uptime") as f:
        return float(f.read().split()[0])


def holds_card(pid):
    """True when ``pid`` has a CUDA device file open (/dev/nvidia*): the
    driver opens them when the process creates a context."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                    "/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def compute_app_pids():
    res = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {int(x) for x in res.stdout.split() if x.strip().isdigit()}


def phase_fleet(dev, root):
    """``serve --store writeplane:ROOT --fleet FLEET_BACKENDS --port 0``
    in process mode over the write-plane phase's (a) root, with checks:
    the serve phase's tile list for this store, png and json, fetched
    cold then warm through the router equals a single-process ServeApp
    over the same store (status, bytes, ETag), which is also fetched
    cold and warm over HTTP for the latencies; /healthz names every
    backend; a child SIGKILLed while the list is fetched costs no 500
    (every answer a 200 equal to the app's or a typed 503), the
    supervisor restarts it, it is back on the ring within
    FLEET_RESTART_WAIT_S and the router's /metrics reads one restart for
    it; no fleet process holds a CUDA context (nvidia-smi's compute
    apps, and no /dev/nvidia* file open)."""
    import signal
    import threading
    import urllib.error
    import urllib.request

    from heatmap_tpu_torch.serve import (ServeApp, TileCache, TileStore,
                                         serve_in_thread)

    t_phase = time.perf_counter()
    spec = f"writeplane:{root}"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t_spawn = uptime_s()
    proc = subprocess.Popen(
        [sys.executable, "-m", "heatmap_tpu_torch", "serve", "--store", spec,
         "--fleet", str(FLEET_BACKENDS), "--port", "0"],
        cwd=here, env=env, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    out = {"phase": "fleet", "backends": FLEET_BACKENDS, "store": "a"}
    app_server = None
    try:
        banner = json.loads(proc.stderr.readline())
        t_banner = uptime_s()
        base = banner["serving"]
        assert sorted(banner["fleet"]) == [f"b{i}" for i in
                                           range(FLEET_BACKENDS)], banner
        # In spawn order: b0 first.
        children = sorted(child_pids(proc.pid), key=start_seconds)
        assert len(children) == FLEET_BACKENDS, children
        # The supervisor spawns one child after the previous one wrote
        # its port file, so each child's start marks its predecessor's
        # port file; the banner follows the last one.
        starts = [start_seconds(c) for c in children] + [t_banner]
        out["spawn_to_port_file_s"] = [starts[i + 1] - starts[i]
                                       for i in range(FLEET_BACKENDS)]
        out["command_to_banner_s"] = t_banner - t_spawn
        # Where a child's start goes: its imports (a fresh interpreter,
        # as the child's), then the store's mount (``mount_s`` below).
        out["child_import_s"] = float(subprocess.run(
            [sys.executable, "-c", "import time; t = time.perf_counter(); "
             "import heatmap_tpu_torch.serve.fleet; "
             "print(time.perf_counter() - t)"],
            cwd=here, env=env, capture_output=True, text=True, check=True,
            timeout=300).stdout.split()[-1])

        def get(path):
            try:
                with urllib.request.urlopen(base + path, timeout=60) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        health = json.loads(get("/healthz")[1])
        assert sorted(health["fleet"]["eligible"]) == sorted(
            banner["fleet"]), health
        # The single-process reference, over HTTP for its latencies.
        t0 = time.perf_counter()
        app = ServeApp(TileStore(spec), TileCache())
        out["mount_s"] = time.perf_counter() - t0
        tiles = serve_tile_list(app.store, SERVE_TILES, SERVE_EMPTY,
                                SERVE_ZOOMS, 1)
        paths = tile_paths(tiles)
        app_server, app_base = serve_in_thread(app)
        lat = {}
        for who, url in (("single", app_base), ("fleet", base)):
            for temp in ("cold", "warm"):
                t0 = time.perf_counter()
                lat[(who, temp)], got = fetch(url, paths)
                s = time.perf_counter() - t0
                out.setdefault(who, {})[temp] = {
                    **pct_ms(lat[(who, temp)]),
                    "requests_per_s": len(paths) / s}
                if who == "single" and temp == "cold":
                    check_tiles(tiles, got)
                    want = got
                else:
                    for p in paths:
                        assert got[p] == want[p], f"{who} {temp} {p}"
        app_server.shutdown()
        app_server.server_close()
        app_server = None
        out["requests"] = len(paths)
        # H-c: nothing of the fleet holds the card; this process does.
        visible = compute_app_pids()
        fleet_pids = [proc.pid, *children]
        assert not any(holds_card(p) for p in fleet_pids), fleet_pids
        assert not visible & set(fleet_pids), (visible, fleet_pids)
        out["cuda_context_pids"] = {
            "smoke_visible_to_nvidia_smi": os.getpid() in visible,
            "smoke_holds_card": holds_card(os.getpid()),
            "fleet_holding_card": []}
        # Kill one child while the list is fetched: no 500, a restart.
        victim_id, victim = "b0", children[0]
        answers = {"got": {}, "lat": []}
        started, done = threading.Event(), threading.Event()

        def client():
            # The list over one keep-alive connection, as ``fetch``; the
            # kill comes once a quarter of it is answered.
            import http.client
            import urllib.parse

            u = urllib.parse.urlsplit(base)
            conn = http.client.HTTPConnection(u.hostname, u.port,
                                              timeout=600)
            try:
                for i, p in enumerate(paths):
                    if i == len(paths) // 4:
                        started.set()
                    t0 = time.perf_counter()
                    conn.request("GET", p)
                    r = conn.getresponse()
                    body = r.read()
                    answers["lat"].append(time.perf_counter() - t0)
                    answers["got"][p] = (r.status, r.getheader("ETag"), body)
            finally:
                conn.close()
                started.set()
                done.set()

        th = threading.Thread(target=client, daemon=True)
        th.start()
        assert started.wait(300), "the client did not start"
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        th.join(300)
        assert done.is_set(), "the client hung through the kill"
        assert len(answers["got"]) == len(paths), "requests went missing"
        codes = {}
        for p in paths:
            status, _, body = answers["got"][p]
            codes[status] = codes.get(status, 0) + 1
            if status == 503:
                assert "cause" in json.loads(body), (p, body)
            else:
                assert (status, body) == (want[p][0], want[p][2]), p
        assert set(codes) <= {200, 404, 503}, codes
        back = None
        while time.perf_counter() - t_kill < FLEET_RESTART_WAIT_S:
            health = json.loads(get("/healthz")[1])
            now = child_pids(proc.pid)
            if victim_id in health["fleet"]["eligible"] and victim not in now:
                back = time.perf_counter() - t_kill
                break
            time.sleep(0.05)
        assert back is not None, "the killed backend did not return"
        metrics = get("/metrics")[1].decode()
        assert (f'fleet_backend_restarts_total{{backend="{victim_id}"}} 1'
                in metrics), "no restart counted"
        children_after = child_pids(proc.pid)
        assert len(children_after) == FLEET_BACKENDS, children_after
        _, got = fetch(base, paths)
        for p in paths:
            assert got[p] == want[p], f"after restart {p}"
        fleet_pids = [proc.pid, *children_after]
        assert not any(holds_card(p) for p in fleet_pids), fleet_pids
        assert not compute_app_pids() & set(fleet_pids)
        out["kill"] = {"statuses": {str(k): v for k, v in codes.items()},
                       "during_kill": pct_ms(answers["lat"]),
                       "back_on_ring_s": back, "restarts": 1,
                       "equal_after_restart": True}
    finally:
        if app_server is not None:
            app_server.shutdown()
            app_server.server_close()
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            pass
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(30)
    out["equal_single_process"] = True
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


class ReplaySource:
    """Columnar batches made once and replayed on every ``batches`` call
    (at the batch size they were cut to), so the stream's cases and
    their CPU twins read the same points without regenerating them."""

    def __init__(self, batches, batch_size):
        self._batches = batches
        self.batch_size = batch_size
        self.points = sum(int((np.asarray(b["source"], object)
                               != "background").sum()) for b in batches)

    def batches(self, batch_size):
        assert batch_size == self.batch_size, (batch_size, self.batch_size)
        yield from self._batches


def hour_parquet(tmp, n, seed, hour):
    """SyntheticSource(n, seed)'s points as a Parquet file with their
    stamps rewritten into hour ``hour`` from TEMPORAL_T0 (spread over
    the hour in row order); the path is reused once written."""
    from heatmap_tpu_torch.delta import read_columns
    from heatmap_tpu_torch.io import SyntheticSource

    path = os.path.join(tmp, f"h{hour:02d}_{n}_{seed}.parquet")
    if not os.path.exists(path):
        cols = read_columns(SyntheticSource(n=n, seed=seed))
        cols["timestamp"] = (TEMPORAL_T0 + 3600 * hour
                             + np.arange(n, dtype=np.int64) * 3600 // n)
        write_parquet(path, cols)
    return path


def hour_survivors(tmp, n_base, n_inc, hours, seed0, retracted):
    """The points of hour 0 (the base) and ``hours``, without
    TEMPORAL_USER's rows in the hours of ``retracted``, as a Parquet
    file: a clean recompute's input."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    tables = []
    for h in (0, *hours):
        t = pq.read_table(hour_parquet(tmp, n_inc if h else n_base,
                                       seed0 + h, h))
        if h in retracted:
            users = np.asarray(t.column("user_id").to_pylist())
            t = t.filter(pa.array(users != TEMPORAL_USER))
        tables.append(t)
    path = os.path.join(tmp, f"survivors_{len(hours)}_{seed0}.parquet")
    pq.write_table(pa.concat_tables(tables), path)
    return path


def temporal_sequence(root, device, tmp, n_base, n_inc, hours, late_hours,
                      seed0, bucketed=True):
    """The temporal phase's sequence through ``cli.main`` on ``device``:
    ``update --bucket-width 3600`` (without it when not ``bucketed``)
    with the hour-0 base, one increment per hour of ``hours`` (seed
    ``seed0 + hour``), a compaction, the ``late_hours`` increments,
    ``retract --where user=TEMPORAL_USER`` and a compaction (both at the
    command's retention). Each step's summary, seconds, segment-reduce
    launches and tracer spans, and after each compaction the base's
    TEMPORAL.json."""
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.temporal import buckets as tb
    from heatmap_tpu_torch.utils.trace import get_tracer

    upd = ["update", "--journal", root, "--device", device]
    steps = [("base", [*upd, *(["--bucket-width", "3600"] if bucketed
                                else []),
                       "--input", "parquet:" + hour_parquet(
                           tmp, n_base, seed0, 0)])]
    steps += [(f"hour_{h}", [*upd, "--input", "parquet:" + hour_parquet(
        tmp, n_inc, seed0 + h, h)]) for h in hours]
    steps.append(("compaction_1", [*upd, "--compact-after", "0"]))
    steps += [(f"hour_{h}", [*upd, "--input", "parquet:" + hour_parquet(
        tmp, n_inc, seed0 + h, h)]) for h in late_hours]
    steps.append(("retract", ["retract", "--journal", root, "--device",
                              device, "--where", f"user={TEMPORAL_USER}"]))
    steps.append(("compaction_2", [*upd, "--compact-after", "0"]))
    tracer = get_tracer()
    out = {}
    for name, argv in steps:
        tracer.reset()
        sp.aggregate_sorted_keys_partitioned.launches = 0
        summary, seconds = cli_call(argv)
        out[name] = {"summary": summary, "seconds": seconds,
                     "launches": sp.aggregate_sorted_keys_partitioned.launches,
                     "spans_s": {k: v["total_s"]
                                 for k, v in tracer.report().items()}}
        if name.startswith("compaction"):
            base = os.path.join(root, summary["compaction"]["base"])
            out[name]["manifest"] = tb.read_manifest(base)
    return out


def expected_buckets(hour_epochs, max_hour):
    """{bucket name: (tier, epochs)} of the JAX package's bucket ladder
    at width 3600, fanout 4, keep 8, for journal entries by hour
    (``hour_epochs``: hour -> epochs) when the newest edge is hour
    ``max_hour``: an hour whose end is under 8 hours old stays a tier-0
    bucket, an older one joins its aligned 4-hour tier-1 bucket (under
    40 hours of age, tier 1 is the top this phase reaches), and so does
    a young hour inside a 4-hour block that holds an old one."""
    old_blocks = {h // 4 for h in hour_epochs if max_hour - (h + 1) >= 8}
    assert all(max_hour - (h + 1) < 40 for h in hour_epochs)
    out = {}
    for h, epochs in sorted(hour_epochs.items()):
        start, span, tier = ((h // 4 * 4, 4, 1) if h // 4 in old_blocks
                             else (h, 1, 0))
        name = (f"bucket-{TEMPORAL_T0 + 3600 * start}-"
                f"{TEMPORAL_T0 + 3600 * (start + span)}")
        eps = out.get(name, (tier, []))[1]
        out[name] = (tier, sorted(eps + list(epochs)))
    return out


def check_temporal_sequence(seq, n_levels, hours, late_hours):
    """Launches, manifests and the retraction of one bucketed sequence:
    n_levels segment reduces per applied batch and per counter-batch,
    none per compaction; each compaction's TEMPORAL.json lists the
    buckets ``expected_buckets`` names, with their tiers and epochs;
    the retraction lands one counter-batch per hour of its horizon (the
    two newest folded entries, retention 2, and the live ones). Returns
    the counter-batch epochs by hour."""
    epochs = {0: [seq["base"]["summary"]["applied"][0]["epoch"]]}
    for h in (*hours, *late_hours):
        (a,) = seq[f"hour_{h}"]["summary"]["applied"]
        assert not a["duplicate"] and a["rows"] > 0, a
        assert seq[f"hour_{h}"]["launches"] == n_levels, h
        epochs[h] = [a["epoch"]]
    assert seq["base"]["launches"] == n_levels
    assert seq["base"]["summary"]["temporal"] == {
        "width": 3600.0, "fanout": 4, "keep": 8, "tiers": 4,
        "unit_s": 1.0}, seq["base"]["summary"]
    ret = seq["retract"]["summary"]
    all_hours = sorted(epochs)
    horizon = [*sorted((0, *hours))[-2:], *late_hours]
    assert ret["entries"] == len(horizon) and ret["rows"] > 0, ret
    assert ret["batches"] == len(horizon), ret
    assert seq["retract"]["launches"] == n_levels * len(horizon)
    counter = dict(zip(horizon, ret["epochs"]))
    for step, hs, last in (("compaction_1", [0, *hours], max(hours)),
                           ("compaction_2", all_hours, max(all_hours))):
        rec = seq[step]
        assert rec["launches"] == 0 and rec["summary"]["live_deltas"] == 0
        man = rec["manifest"]
        assert man["none"] is None and man["max_edge"] == float(
            TEMPORAL_T0 + 3600 * (last + 1)), man["max_edge"]
        by_hour = {h: epochs[h] + ([counter[h]] if step == "compaction_2"
                                   and h in counter else []) for h in hs}
        want = expected_buckets(by_hour, last + 1)
        got = {b["name"]: (b["tier"], b["epochs"]) for b in man["buckets"]}
        assert got == want, (step, got, want)
    return counter


def base_files(root):
    """{name: bytes} of the top-level files of CURRENT's base (the
    all-time artifact; buckets/ and TEMPORAL.json are temporal-only)."""
    from heatmap_tpu_torch.delta.compact import read_current

    base = os.path.join(root, read_current(root)["base"])
    return {n: open(os.path.join(base, n), "rb").read()
            for n in sorted(os.listdir(base))
            if os.path.isfile(os.path.join(base, n))
            and n != "TEMPORAL.json"}


def temporal_tree(root):
    """CURRENT's base's TEMPORAL.json and bucket files."""
    from heatmap_tpu_torch.delta.compact import read_current

    base = os.path.join(root, read_current(root)["base"])
    return {k: v for k, v in read_tree(base).items()
            if k == "TEMPORAL.json" or k.startswith("buckets" + os.sep)}


def fold_seconds(base_url):
    """(sum, count) of ``temporal_fold_seconds`` on a server's
    /metrics."""
    import urllib.request

    with urllib.request.urlopen(base_url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    got = {}
    for line in text.splitlines():
        for key in ("temporal_fold_seconds_sum",
                    "temporal_fold_seconds_count"):
            if line.startswith(key + " ") or line.startswith(key + "{"):
                got[key] = got.get(key, 0.0) + float(line.split()[-1])
    return (got.get("temporal_fold_seconds_sum", 0.0),
            got.get("temporal_fold_seconds_count", 0.0))


def brute_growth(root, sel, zoom, window, layer=("all", "alltime")):
    """Exact growth per cell of a window selection: the newer half's
    sum less the older half's over the selected units' level rows at
    ``zoom`` (no wavelets; each unit's one level file is read)."""
    from heatmap_tpu_torch.delta.compact import read_current

    base = read_current(root).get("base")
    units = [(os.path.join(root, base, "buckets", b["name"]), float(b["t1"]))
             for b in sel.buckets]
    units += [(os.path.join(root, u["artifact"]), u["t1"]) for u in sel.live]
    mid = sel.ref - window / 2.0
    acc = {}
    for d, t1 in units:
        path = os.path.join(d, f"level_z{zoom:02d}.npz")
        if not os.path.exists(path):
            continue
        with np.load(path) as z:
            lvl = {k: z[k] for k in z.files}
        keep = ((lvl["user_names"][lvl["user_idx"]] == layer[0])
                & (lvl["timespan_names"][lvl["timespan_idx"]] == layer[1]))
        sign = 1.0 if t1 > mid else -1.0
        for r, c, v in zip(np.asarray(lvl["row"])[keep].tolist(),
                           np.asarray(lvl["col"])[keep].tolist(),
                           np.asarray(lvl["value"])[keep].tolist()):
            acc[(r, c)] = acc.get((r, c), 0.0) + sign * v
    return acc


def check_growth(doc, exact):
    """Every reported cell's growth within its stamped bound of the
    exact growth, and max_err the largest bound."""
    assert doc["cells"], doc
    for cell in doc["cells"]:
        want = exact.get((cell["row"], cell["col"]), 0.0)
        assert abs(cell["growth"] - want) <= cell["bound"] + 1e-9, \
            (cell, want)
    assert doc["max_err"] == max(c["bound"] for c in doc["cells"])


def start_serve_process(spec):
    """``python -m heatmap_tpu_torch serve --store SPEC --port 0`` as a
    process in its own session: (process, its start on the perf
    clock)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "heatmap_tpu_torch", "serve", "--store",
         spec, "--port", "0"],
        cwd=here, env=env, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return proc, t0


def serve_temporal(root, tmp, retracted, proc, t0):
    """Over ``serve --store delta:ROOT --port 0`` (``proc``, started at
    ``t0`` by ``start_serve_process``) on the big temporal store, with
    the hours in ``retracted`` retracted: a ``run --output arrays:`` over
    the batches inside the as_of cut, mounted as ``arrays:``, whose most
    populated tiles (``serve_tile_list``) are fetched in each cut
    (all-time, as_of at hour TEMPORAL_AS_OF_HOUR's edge, window 1d and
    1h, decay 1h) cold then warm, with each cut's fold seconds from the
    server's /metrics; the as_of tiles equal the recompute's, the
    window-1d tiles (a fold over every bucket) the all-time tiles;
    TEMPORAL_GROWTH_QUERIES ``op=topk_growth`` requests over window 1h
    and one over 1d, each within its stamped bound of the exact
    growth."""
    from heatmap_tpu_torch.serve import ServeApp, TileCache, TileStore
    from heatmap_tpu_torch.temporal import fold as tfold

    out = {}
    banner = json.loads(proc.stderr.readline())
    out["command_to_banner_s"] = time.perf_counter() - t0
    base_url = banner["serving"]
    # The as_of oracle: one run over the batches inside the cut, less
    # the rows the retraction removed from them, mounted as arrays:.
    # The tile list is its most populated tiles (populated in every cut
    # that holds the cut's batches).
    hours = [h for h in TEMPORAL_HOURS if h < TEMPORAL_AS_OF_HOUR]
    oracle_dir = os.path.join(tmp, "as_of_oracle")
    _, out["oracle_run_s"] = cli_call([
        "run", "--input", "parquet:" + hour_survivors(
            tmp, N_TEMPORAL_BASE, N_TEMPORAL_INC, hours, 0,
            retracted),
        "--output", f"arrays:{oracle_dir}", "--device", "cuda"])
    t1 = time.perf_counter()
    oracle = ServeApp(TileStore(f"arrays:{oracle_dir}"), TileCache())
    out["oracle_mount_s"] = time.perf_counter() - t1
    tiles = serve_tile_list(oracle.store, TEMPORAL_TILES, TEMPORAL_EMPTY,
                            SERVE_ZOOMS, 5)
    as_of = TEMPORAL_T0 + 3600 * TEMPORAL_AS_OF_HOUR
    cuts = {"all_time": "", "as_of": f"as_of={as_of}",
            "window_1d": "window=1d", "window_1h": "window=1h",
            "decay_1h": "decay=1h"}
    plain = tile_paths(tiles)
    answers = {}
    for name, q in cuts.items():
        paths = [p + ("?" + q if q else "") for p in plain]
        f0 = fold_seconds(base_url)
        t1 = time.perf_counter()
        cold_lat, cold = fetch(base_url, paths)
        cold_s = time.perf_counter() - t1
        f1 = fold_seconds(base_url)
        warm_lat, warm = fetch(base_url, paths)
        assert warm == cold, name
        assert fold_seconds(base_url) == f1, name
        statuses = [cold[p][0] for p in paths]
        assert set(statuses) <= {200, 404}, (name, set(statuses))
        if q:
            assert all(cold[p][1].startswith('"t-') for p in paths
                       if cold[p][0] == 200), name
        answers[name] = [cold[p] for p in paths]
        out[name] = {"cold": {**pct_ms(cold_lat),
                              "requests_per_s": len(paths) / cold_s},
                     "warm": pct_ms(warm_lat),
                     "fold_s": f1[0] - f0[0],
                     "folds": f1[1] - f0[1],
                     "tiles_200": statuses.count(200)}
    check_tiles(tiles, dict(zip(plain, answers["as_of"])))
    # A fold over every bucket serves the all-time bytes.
    everything = tfold.select_fold(root, window=86400.0)
    assert len(everything.buckets) == len(tfold.select_fold(
        root).buckets) and not everything.live
    for a, b in zip(answers["window_1d"], answers["all_time"]):
        assert (a[0], a[2]) == (b[0], b[2])
    # The as_of cut serves the recompute's bytes.
    for p, got in zip(plain, answers["as_of"]):
        want = oracle.handle("GET", p)
        assert got[0] == want[0], p
        if got[0] == 200:
            assert got[2] == want[2], p
    assert out["as_of"]["tiles_200"] > 0
    # topk_growth: window 1h is one slot, so every answer is exact;
    # window 1d spans every bucket and is bounded.
    sel_1h = tfold.select_fold(root, window=3600.0)
    exact = {}
    lat = []
    zooms = (12, 14, 16, 18, 20)
    for i in range(TEMPORAL_GROWTH_QUERIES):
        z, k = zooms[i % len(zooms)], 1 + i // len(zooms)
        url = (f"/query?op=topk_growth&layer=all%7Calltime&z={z}"
               f"&window=1h&k={k}")
        t1 = time.perf_counter()
        (status, _, body), = fetch(base_url, [url])[1].values()
        lat.append(time.perf_counter() - t1)
        assert status == 200, (url, body)
        if z not in exact:
            exact[z] = brute_growth(root, sel_1h, z, 3600.0)
        doc = json.loads(body)
        assert doc["slots"] == 1 and len(doc["cells"]) == k, doc
        check_growth(doc, exact[z])
        assert doc["max_err"] == 0.0
    out["topk_growth_1h"] = pct_ms(lat)
    t1 = time.perf_counter()
    (status, _, body), = fetch(base_url, [
        "/query?op=topk_growth&layer=all%7Calltime&z=14&window=1d"
        "&k=20"])[1].values()
    out["topk_growth_1d_s"] = time.perf_counter() - t1
    assert status == 200, body
    doc = json.loads(body)
    check_growth(doc, brute_growth(
        root, tfold.select_fold(root, window=86400.0), 14, 86400.0))
    out["topk_growth_1d"] = {"slots": doc["slots"],
                             "max_err": doc["max_err"]}
    return out


def temporal_ingest(root, tmp, n_levels):
    """``ingest --bucket-width 3600 --serve-port 0`` onto a store at
    ``root`` of one compacted INGEST_MICRO-point batch in hour 0:
    TEMPORAL_INGEST_TICKS ticks of INGEST_MICRO points, two an hour from
    the store's newest edge on (the second hour's
    points 5 degrees east, so its ticks touch other tiles than the
    first's), with the tile list served in ``?window=1h`` before the
    first tick and again after each tick's roll. Each roll must drop
    exactly the cached window-1h entries of the retiring units' tiles
    and no other entry, and the edge must move once. Returns the drain
    record with each roll's counts."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from heatmap_tpu_torch.delta.compute import affected_tile_keys
    from heatmap_tpu_torch.ingest import loop as loop_mod
    from heatmap_tpu_torch.io.sinks import LevelArraysSink
    from heatmap_tpu_torch.temporal import fold as tfold

    cli_call(["update", "--journal", root, "--device", "cuda",
              "--bucket-width", "3600", "--compact-after", "0", "--input",
              "parquet:" + hour_parquet(tmp, INGEST_MICRO, 399, 0)])
    hour0 = int((tfold.newest_edge(root) - TEMPORAL_T0) // 3600)
    parts = []
    for i in range(TEMPORAL_INGEST_TICKS):
        t = pq.read_table(hour_parquet(tmp, INGEST_MICRO, 400 + i,
                                       hour0 + i // 2))
        if i // 2 % 2:
            lon = t.column("longitude")
            t = t.set_column(t.schema.get_field_index("longitude"),
                             "longitude", pc.add(lon, 5.0))
        parts.append(t)
    spec = os.path.join(tmp, "ingest_ticks.parquet")
    pq.write_table(pa.concat_tables(parts), spec)
    rolls, state = [], {}
    real_roll = loop_mod._roll_windows

    def refetch():
        _, got = fetch(state["base"], state["paths"])
        assert {v[0] for v in got.values()} <= {200, 404}

    def roll(r, cache, holder):
        before = set(cache._entries)
        prev = holder[0] if holder else None
        n = real_roll(r, cache, holder)
        after = set(cache._entries)
        ref = holder[0]
        want = set()
        if prev is not None and ref > prev:
            keys = None
            for d in tfold.retiring_dirs(r, prev, ref, [3600.0]):
                got = affected_tile_keys(LevelArraysSink.load(d))
                keys = got if keys is None else keys | got
            want = {k for k in before if len(k) == 7
                    and k[5:] == ("w", "1h") and keys is not None
                    and k[:5] in keys}
        assert before - after == want and n == len(want), (
            len(before - after), len(want), n)
        rolls.append({"prev": prev, "ref": ref, "invalidated": n,
                      "cached": len(before)})
        refetch()
        return n

    def on_serve(app, base_url):
        tiles = serve_tile_list(app.store, TEMPORAL_ROLL_TILES,
                                TEMPORAL_ROLL_TILES // 6, SERVE_ZOOMS, 6)
        state["base"] = base_url
        state["paths"] = [p + "?window=1h" for p in tile_paths(tiles)]
        refetch()

    loop_mod._roll_windows = roll
    try:
        rec = ingest_drain(["ingest", "--journal", root, "--input",
                            f"parquet:{spec}", "--device", "cuda",
                            "--serve-port", "0", "--bucket-width", "3600",
                            "--micro-batch", str(INGEST_MICRO),
                            "--compact-every", "0"], on_serve=on_serve)
    finally:
        loop_mod._roll_windows = real_roll
    check_ticks(rec, n_levels)
    assert rec["stats"].ticks == TEMPORAL_INGEST_TICKS
    assert rec["summary"]["temporal"]["width"] == 3600.0
    moved = [r for r in rolls if r["prev"] is not None
             and r["ref"] > r["prev"]]
    assert len(moved) == TEMPORAL_INGEST_TICKS // 2 - 1, rolls
    assert all(r["invalidated"] > 0 for r in moved), rolls
    rec["rolls"] = rolls
    return rec


def temporal_small(tmp, n_levels):
    """(c) and (d) of ``phase_temporal`` under ``tmp``: the small
    sequence on the card, on the CPU and on the card without buckets
    (bucket dirs, TEMPORAL.json and the whole store equal card and CPU;
    the top-level base equal with and without buckets), then
    ``temporal_ingest``. Returns (the sequences, the drain record)."""
    small = {}
    roots = {}
    for name, device, bucketed in (("cuda", "cuda", True),
                                   ("cpu", "cpu", True),
                                   ("cuda_plain", "cuda", False)):
        roots[name] = os.path.join(tmp, f"temporal_small_{name}")
        small[name] = temporal_sequence(
            roots[name], device, tmp, N_TEMPORAL_SMALL_BASE,
            N_TEMPORAL_SMALL_INC, TEMPORAL_SMALL_HOURS,
            TEMPORAL_SMALL_LATE_HOURS, 200, bucketed=bucketed)
    check_temporal_sequence(small["cuda"], n_levels, TEMPORAL_SMALL_HOURS,
                            TEMPORAL_SMALL_LATE_HOURS)
    assert temporal_tree(roots["cuda"]) == temporal_tree(roots["cpu"]), \
        "card and CPU buckets differ"
    assert (store_tree(roots["cuda"]) == store_tree(roots["cpu"])), \
        "card and CPU temporal stores differ"
    assert base_files(roots["cuda"]) == base_files(roots["cuda_plain"]), \
        "bucketing changed the all-time base"
    for r in roots.values():
        shutil.rmtree(r)
    return small, temporal_ingest(os.path.join(tmp, "temporal_ingest"),
                                  tmp, n_levels)


def phase_temporal(dev, tmp):
    """The temporal plane on the card, as TEMPORAL_* describe, with
    checks: (a) n_levels segment-reduce launches per applied batch and
    counter-batch, none per compaction; each compaction's TEMPORAL.json
    lists the bucket ladder's buckets with their tiers and epochs (the
    oldest hours coarsened into tier 1), and the retraction lands one
    counter-batch per hour of its horizon; (b) served over HTTP by a
    ``serve`` process (``serve_temporal``), which mounts the big store
    while (c) the small sequence writes byte-equal bucket dirs and
    TEMPORAL.json on the card and the CPU, and the same top-level base
    with and without ``--bucket-width``, and (d) ``ingest --bucket-width
    --serve-port`` drains onto a one-batch store, each roll dropping
    exactly the retiring window entries (``temporal_small``). Returns
    the big sequence's launches."""
    import signal

    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    t_phase = time.perf_counter()
    n_levels = BatchJobConfig().cascade_config().n_levels + 1
    pq_dir = os.path.join(tmp, "temporal_inputs")
    os.makedirs(pq_dir)
    t0 = time.perf_counter()
    for h in (0, *TEMPORAL_HOURS, *TEMPORAL_LATE_HOURS):
        hour_parquet(pq_dir, N_TEMPORAL_BASE if h == 0 else N_TEMPORAL_INC,
                     h, h)
    inputs_s = time.perf_counter() - t0
    root = os.path.join(tmp, "temporal_store")
    seq = temporal_sequence(root, "cuda", pq_dir, N_TEMPORAL_BASE,
                            N_TEMPORAL_INC, TEMPORAL_HOURS,
                            TEMPORAL_LATE_HOURS, 0)
    counter = check_temporal_sequence(seq, n_levels, TEMPORAL_HOURS,
                                      TEMPORAL_LATE_HOURS)
    launches = sum(rec["launches"] for rec in seq.values())
    # The server mounts the big store while (c) and (d) run.
    proc, t_spawn = start_serve_process(f"delta:{root}")
    try:
        small, ingest_rec = temporal_small(pq_dir, n_levels)
        served = serve_temporal(root, pq_dir, set(counter), proc, t_spawn)
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(60)
    shutil.rmtree(root)
    steps = {k: {"seconds": v["seconds"], "launches": v["launches"]}
             for k, v in seq.items()}
    applied = [v for k, v in seq.items() if k.startswith("hour_")]
    emit({"phase": "temporal", "base_points": N_TEMPORAL_BASE,
          "increment_points": N_TEMPORAL_INC,
          "increments": len(TEMPORAL_HOURS) + len(TEMPORAL_LATE_HOURS),
          "inputs_s": inputs_s, "launches": launches,
          "steps": steps,
          "apply": {k: apply_split(v, v["summary"]["applied"][0]["points"])
                    for k, v in seq.items()
                    if k == "base" or k.startswith("hour_")},
          "increment_median_s": statistics.median(
              v["seconds"] for v in applied),
          "compactions": {k: {"seconds": seq[k]["seconds"],
                              "buckets": len(seq[k]["manifest"]["buckets"]),
                              "tiers": sorted(b["tier"] for b in
                                              seq[k]["manifest"]["buckets"])}
                          for k in ("compaction_1", "compaction_2")},
          "retraction": {"rows": seq["retract"]["summary"]["rows"],
                         "batches": seq["retract"]["summary"]["batches"],
                         "scanned": seq["retract"]["summary"]["scanned"],
                         "seconds": seq["retract"]["seconds"],
                         "counter_epochs": len(counter)},
          "serve": served,
          "small_seconds": {k: sum(r["seconds"] for r in v.values())
                            for k, v in small.items()},
          "small_equal_cpu": True, "base_equal_unbucketed": True,
          "ingest": {"ticks_s": ingest_rec["ticks_s"],
                     "seconds": ingest_rec["seconds"],
                     "launches": [a["launches"]
                                  for a in ingest_rec["applies"]],
                     "rolls": ingest_rec["rolls"]},
          "phase_s": time.perf_counter() - t_phase})
    return launches


def stream_sources():
    """``synthetic:N_TILES`` (seed 0) cut to the stream's default batch;
    the same points in 1M-point batches (16 default batches each); and
    those with an integer ``value`` column in [0, WEIGHT_BOUND]."""
    from heatmap_tpu_torch.io import SyntheticSource

    small = list(SyntheticSource(n=N_TILES, seed=0).batches(STREAM_BATCH))
    per = STREAM_BIG_BATCH // STREAM_BATCH
    big = []
    for i in range(0, len(small), per):
        part = small[i:i + per]
        big.append({k: (np.concatenate([b[k] for b in part])
                        if isinstance(part[0][k], np.ndarray)
                        else sum((b[k] for b in part), []))
                    for k in part[0]})
    valued = []
    for i, b in enumerate(big):
        rng = np.random.default_rng([3, 7, i])
        valued.append({**b, "value": rng.integers(
            0, WEIGHT_BOUND + 1, len(b["latitude"])).astype(np.float64)})
    return (ReplaySource(small, STREAM_BATCH),
            ReplaySource(big, STREAM_BIG_BATCH),
            ReplaySource(valued, STREAM_BIG_BATCH))


def stream_args(spec, out, device, *extra):
    from heatmap_tpu_torch.cli import build_parser

    return build_parser().parse_args(
        ["stream", "--input", spec, "--output", out, "--device", device,
         *extra])


def window_counters():
    from heatmap_tpu_torch.ops import pallas_kernels as pk
    from heatmap_tpu_torch.ops import partitioned as pt

    return {"window_histogram": pk.bin_rowcol_window_pallas.launches,
            "window_partitioned": pt.bin_rowcol_window_partitioned.launches,
            "window_partitioned_weighted":
                pt.bin_rowcol_window_partitioned.weighted_launches}


def zero_window_counters():
    from heatmap_tpu_torch.ops import pallas_kernels as pk
    from heatmap_tpu_torch.ops import partitioned as pt

    pk.bin_rowcol_window_pallas.launches = 0
    pt.bin_rowcol_window_partitioned.launches = 0
    pt.bin_rowcol_window_partitioned.weighted_launches = 0


def stream_update_split(dev, args, source):
    """Where one stream update's time goes at a case's tick shape (the
    first batch padded to ``--batch-points``, the padding masked): the
    median ms (host clock, device fenced) of the host padding, the
    host-to-device copies, the f64 projection, the binning and a whole
    ``HeatmapStream.update``, and the device time by kernel of one update
    (``device_us``). Returns that record and ``(window, row, col,
    valid)`` as the tick gives them to its binning kernel."""
    from heatmap_tpu_torch.cli import tiles_window
    from heatmap_tpu_torch.ops.histogram import bin_rowcol_window
    from heatmap_tpu_torch.pipeline.batch import load_columns
    from heatmap_tpu_torch.streaming import HeatmapStream, StreamConfig
    from heatmap_tpu_torch.tilemath.mercator import project_points

    window = tiles_window(args)
    cols = load_columns(next(iter(source.batches(args.batch_points))))
    n = len(cols["latitude"])
    pad = args.batch_points - n

    def timed(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), out

    pad_ms, (lat, lon, valid) = timed(lambda: (
        np.concatenate([cols["latitude"], np.zeros(pad)]),
        np.concatenate([cols["longitude"], np.zeros(pad)]),
        np.arange(args.batch_points) < n))
    h2d_ms, (tlat, tlon, tvalid) = timed(lambda: tuple(
        torch.as_tensor(x, device=dev) for x in (lat, lon, valid)))
    project_ms, (row, col, ok) = timed(lambda: project_points(
        tlat, tlon, window.zoom, dtype=torch.float64))
    bin_ms, _ = timed(lambda: bin_rowcol_window(
        row, col, window, valid=ok & tvalid, dtype=torch.float32,
        backend=args.bin_backend))
    stream = HeatmapStream(StreamConfig(
        window=window, proj_dtype=torch.float64, pad_to=args.batch_points,
        backend=args.bin_backend), device=dev)
    clock = iter(range(10 ** 6))

    def update():
        return stream.update(cols["latitude"], cols["longitude"],
                             60.0 * next(clock))

    update_ms, _ = timed(update)
    return ({"points": n, "batch": args.batch_points, "pad_ms": pad_ms,
             "h2d_ms": h2d_ms, "project_ms": project_ms, "bin_ms": bin_ms,
             "update_ms": update_ms,
             "device_us": device_us(update, iters=5)},
            (window, row, col, ok & tvalid))


def run_stream_pair(dev, tmp, name, spec, source, extra, kernel):
    """One stream case on the card (launches counted) and on the CPU:
    the card's summary, launches, raster and PNG tree against the CPU's.
    Returns the record and both PNG trees."""
    from heatmap_tpu_torch.cli import run_stream_command

    snaps, trees, summaries = {}, {}, {}
    for side, device in (("card", dev.type), ("cpu", "cpu")):
        out = os.path.join(tmp, name, side)
        args = stream_args(spec, out, device, *extra)
        if side == "card":
            zero_window_counters()
        summaries[side], snaps[side], _ = run_stream_command(args,
                                                             source=source)
        if side == "card":
            torch.cuda.synchronize()
            used = window_counters()
        trees[side] = read_tree(out)
    card, host = snaps["card"], snaps["cpu"]
    summary = summaries["card"]
    ticks = summary["batches"]
    assert card.dtype == host.dtype == np.float32, (card.dtype, host.dtype)
    assert np.isfinite(card).all() and card.sum() > 0, name
    assert used[kernel] == ticks > 0, (name, used, ticks)
    assert sum(used.values()) == ticks, (name, used)
    nz = (card != 0) | (host != 0)
    rel = float((np.abs(card.astype(np.float64) - host)[nz]
                 / np.abs(host.astype(np.float64))[nz].clip(
                     min=1e-30)).max()) if nz.any() else 0.0
    np.testing.assert_allclose(card, host, rtol=STREAM_RTOL, atol=0)
    assert summaries["cpu"]["batches"] == ticks, name
    update_ms = summary["stage_ms"]["update"]
    rec = {"ticks": ticks, "window": summary["window"],
           "bin_backend": summary["bin_backend"], "launches": used,
           "launches_per_tick": used[kernel] / ticks,
           "ms_per_tick": update_ms / ticks,
           "wall_ms_per_tick": summary["seconds"] * 1e3 / ticks,
           "seconds": summary["seconds"], "stage_ms": summary["stage_ms"],
           "points": source.points if source is not None else None,
           "points_per_s": (source.points / summary["seconds"]
                            if source is not None else None),
           "live_mass": summary["live_mass"], "tiles": summary["tiles"],
           "raster_bit_equal_to_cpu": bool(np.array_equal(card, host)),
           "max_rel_err_vs_cpu": rel,
           "png_equal_to_cpu": trees["card"] == trees["cpu"],
           "cpu_seconds": summaries["cpu"]["seconds"]}
    return rec, trees


def phase_stream(dev, csv_path):
    """The ``stream`` command on the card, each case with the kernels'
    counts set to 0 just before it and read just after: (a) defaults on
    4M synthetic points (62 ticks of 65,536, a 256x256 z12 window: one
    window-histogram launch a tick), (b) ``--zoom 16 --batch-points
    1048576`` (4 ticks, 1792x1280: one bucketed launch a tick), (c) (b)
    with ``--weighted`` on integer values in [0, 100] (one weighted
    bucketed launch a tick), each against the same run on the CPU;
    (a) and (c) again with no decay (``--half-life 1e18``), bit-equal
    to the CPU; (d) (a)'s flags on the 4M-point CSV ``csv_path``:
    checkpointed over its first 31 batches (half the ticks, a whole
    number of batches, so the replay lines up at the checkpoint),
    resumed over the whole file, bit-equal to an uninterrupted run. The
    window kernels are held against their plain versions at (a)'s and
    (b)'s tick shapes first, beside the split of one update's time."""
    from heatmap_tpu_torch.cli import run_stream_command
    from heatmap_tpu_torch.ops import pallas_kernels as pk
    from heatmap_tpu_torch.ops import partitioned as pt

    small, big, valued = stream_sources()
    spec = f"synthetic:{N_TILES}"
    z16 = ("--zoom", "16", "--batch-points", str(STREAM_BIG_BATCH))
    cases = {
        "defaults": ((), small, "window_histogram"),
        "z16": (z16, big, "window_partitioned"),
        "z16_weighted": (z16 + ("--weighted",), valued,
                         "window_partitioned_weighted"),
    }
    kernel_checks = {}
    update_split = {}
    for name, fn, plain in (
            ("defaults", pk.bin_rowcol_window_pallas, pk._plain),
            ("z16", pt.bin_rowcol_window_partitioned, pt._plain)):
        extra, source, _ = cases[name]
        update_split[name], (window, row, col, valid) = stream_update_split(
            dev, stream_args(spec, "", dev.type, *extra), source)
        kernel_checks[name] = {
            "checks": check_window_kernel(
                fn, plain, window, window_cases(window, row, col, valid, dev)),
            "counts": time_window_kernel(fn, plain, window, row, col, valid),
            "int_weights": time_window_kernel(
                fn, plain, window, row, col, valid,
                int_weights(row.shape[0], dev))}
    del window, row, col, valid
    ticks = -(-N_TILES // STREAM_BATCH)
    half = ticks // 2
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (extra, source, kernel) in cases.items():
            runs[name], _ = run_stream_pair(dev, tmp, name, spec, source,
                                            extra, kernel)
        assert runs["defaults"]["ticks"] == ticks, runs["defaults"]
        # No decay: the decay factor is exactly 1, so counts and integer
        # weights are exact on both sides.
        for name in ("defaults", "z16_weighted"):
            extra, source, kernel = cases[name]
            rec, trees = run_stream_pair(
                dev, tmp, f"{name}_no_decay", spec, source,
                extra + ("--half-life", "1e18"), kernel)
            assert rec["raster_bit_equal_to_cpu"], name
            assert rec["png_equal_to_cpu"] and trees["card"], name
            runs[f"{name}_no_decay"] = rec
        # Resume: a checkpoint written over the first half of the CSV's
        # batches, then the whole CSV with the same checkpoint dir.
        prefix = os.path.join(tmp, "prefix.csv")
        with open(csv_path) as src, open(prefix, "w") as dst:
            for _ in range(1 + half * STREAM_BATCH):
                dst.write(src.readline())
        ckpt = os.path.join(tmp, "ckpt")
        resume = {}
        for name, path, ck in (("first_half", prefix, ckpt),
                               ("resumed", csv_path, ckpt),
                               ("uninterrupted", csv_path, None)):
            extra = ("--checkpoint-dir", ck) if ck else ()
            zero_window_counters()
            summary, snap, _ = run_stream_command(stream_args(
                f"csv:{path}", os.path.join(tmp, "resume", name), dev.type,
                *extra))
            torch.cuda.synchronize()
            resume[name] = {"summary": summary, "snap": snap,
                            "launches": window_counters()["window_histogram"]}
        assert resume["first_half"]["summary"]["batches"] == half
        assert resume["resumed"]["summary"]["batches"] == ticks
        assert resume["uninterrupted"]["summary"]["batches"] == ticks
        assert resume["resumed"]["launches"] == ticks - half
        assert np.array_equal(resume["resumed"]["snap"],
                              resume["uninterrupted"]["snap"]), \
            "resumed stream differs from the uninterrupted one"
        runs["resume"] = {
            name: {"batches": r["summary"]["batches"],
                   "seconds": r["summary"]["seconds"],
                   "launches": r["launches"],
                   "stage_ms": r["summary"]["stage_ms"]}
            for name, r in resume.items()}
        runs["resume"]["bit_equal_to_uninterrupted"] = True
    emit({"phase": "stream", "points": N_TILES, "rtol": STREAM_RTOL,
          "kernel_checks": kernel_checks, "update_split": update_split,
          "runs": runs})


def phase_stream_bench(dev):
    """The twin of ``tools/bench_stream.py`` at its defaults: a z11 window
    over 35-55N, 5W-20E (aligned to 2^4), 262,144-point batches, 50 steps
    (the first untimed), half-life 600 s, points from
    ``default_rng(7)``; one run per binning backend, each step's
    launches counted, each final raster against an "xla" stream on the
    same points."""
    from heatmap_tpu_torch.ops.histogram import _pick_backend, window_from_bounds
    from heatmap_tpu_torch.streaming import HeatmapStream, StreamConfig

    steps, batch = STREAM_BENCH_STEPS, STREAM_BENCH_BATCH
    window = window_from_bounds((35.0, 55.0), (-5.0, 20.0), zoom=11,
                                align_levels=4)
    rng = np.random.default_rng(7)
    out = {}
    for backend in ("auto", "xla", "pallas", "partitioned"):
        lat = rng.uniform(35.0, 55.0, (steps, batch))
        lon = rng.uniform(-5.0, 20.0, (steps, batch))
        rasters = {}
        for be in dict.fromkeys((backend, "xla")):
            stream = HeatmapStream(StreamConfig(
                window=window, half_life_s=600.0, pad_to=batch, backend=be),
                device=dev)
            stream.update(lat[0], lon[0], t=0.0)
            stream.snapshot()
            zero_window_counters()
            t0 = time.perf_counter()
            for i in range(1, steps):
                stream.update(lat[i], lon[i], t=float(i))
            rasters[be] = stream.snapshot()
            dt = time.perf_counter() - t0
            if be == backend:
                launches = window_counters()
                rec = {"steps_per_s": (steps - 1) / dt,
                       "pts_per_s": (steps - 1) * batch / dt,
                       "seconds": dt,
                       "resolved": _pick_backend(be, window, dev),
                       "launches": launches}
        card, plain = rasters[backend], rasters["xla"]
        np.testing.assert_allclose(card, plain, rtol=STREAM_RTOL, atol=0)
        rec["bit_equal_to_xla"] = bool(np.array_equal(card, plain))
        assert np.isfinite(card).all() and card.sum() > 0, backend
        out[backend] = rec
    assert out["auto"]["resolved"] == "pallas", out["auto"]
    emit({"phase": "stream_bench", "window": [window.height, window.width],
          "zoom": 11, "batch": batch, "steps": steps, "half_life_s": 600.0,
          "backends": out})


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
    with tempfile.TemporaryDirectory() as tmp:
        # The 4M points as a CSV: the fast phase's input, and the
        # stream's resume case.
        csv_path = os.path.join(tmp, "points.csv")
        phase_fast(dev, single, csv_path)
        del single
        phase_resumable(dev)
        phase_weighted(dev)
        phase_cpu_crosscheck(dev)
        phase_parquet(dev)
        delta_root = os.path.join(tmp, "delta_store")
        delta_launches = phase_delta(dev, delta_root)
        ingest_launches, plain_ticks = phase_ingest(dev, delta_root)
        serve_launches, follow_launches = phase_serve(dev, delta_root,
                                                      plain_ticks)
        shutil.rmtree(delta_root)
        plane_root, writeplane_launches = phase_writeplane(dev, tmp)
        phase_fleet(dev, plane_root)
        shutil.rmtree(plane_root)
        temporal_launches = phase_temporal(dev, tmp)
        tiles_launches = phase_tiles(dev)
        phase_stream(dev, csv_path)
    phase_stream_bench(dev)
    phase_splat(dev)
    phase_headline(dev)
    segment_reduce = kernel_entry(
        "segment_reduce", "segment_reduce.cu",
        "heatmap_tpu/ops/sparse_partitioned.py:75", bounded_launches,
        kernel)
    segment_reduce["launches_by_path"] = {"bounded": bounded_launches,
                                          "delta": delta_launches,
                                          "ingest": ingest_launches,
                                          "serve": serve_launches,
                                          "writeplane": writeplane_launches,
                                          "temporal": temporal_launches}
    window_histogram = kernel_entry(
        "window_histogram", "window_histogram.cu",
        "heatmap_tpu/ops/pallas_kernels.py:49",
        tiles_launches["window_histogram"], histogram)
    window_histogram["launches_by_path"] = {
        "tiles": tiles_launches["window_histogram"],
        "serve": follow_launches}
    emit({"kernels": [
        segment_reduce,
        window_histogram,
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
