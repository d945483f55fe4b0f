"""Wavelet-synopsis bench: compression, decode latency, error and
early-serve lag.

The port's twin of ``tools/bench_synopsis.py``. It builds an
``arrays-synopsis:`` store with ``run_job`` on ``--device``, then:

- ``compression``: per synopsized zoom, exact level bytes against
  synopsis bytes, and their aggregate quotient ``bytes_ratio``;
- ``decode``: p50/p99 ms of one pair-level decode at the largest
  synopsized zoom, and ``max_err``, the worst stamped L-inf bound,
  re-verified against a fresh decode of every pair (the stamp is the
  achieved error, so the two must agree exactly; the tool exits with a
  message where one does not);
- ``early_serve``: the lag from ``synopsis_built provisional`` to
  ``delta_applied`` in the events of a real ``ingest.run_ingest`` drain
  (its cascades on ``--device``) onto a delta store whose base carries
  synopses.

The record carries the JAX tool's keys plus ``device`` and, on a card,
``gpu_name`` and ``power_limit_w``.

    python -m heatmap_tpu_torch.tools.bench_synopsis [--points 30000]
        [--seed 7] [--decode-iters 50] [--device cuda|cpu]
        [--out build/torch_bench/bench_synopsis.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from heatmap_tpu_torch.tools._common import (default_out, device_fields, pct,
                                             write_record)

#: The JAX tool's record keys.
RECORD_KEYS = ("bench", "points", "compression", "decode", "early_serve")


def _materialize(spec: str) -> dict:
    from heatmap_tpu_torch.io import open_source

    cols: dict = {}
    for batch in open_source(spec).batches(1 << 20):
        for c, v in batch.items():
            cols.setdefault(c, []).extend(v)
    return cols


def bench_compression(level_dir: str) -> dict:
    """Exact against synopsis artifact bytes per zoom, and in all."""
    from heatmap_tpu_torch.synopsis.build import synopsis_path

    per_zoom, exact_total, syn_total = {}, 0, 0
    for name in sorted(os.listdir(level_dir)):
        if not (name.startswith("level_z") and name.endswith(".npz")):
            continue
        zoom = int(name[len("level_z"):len("level_z") + 2])
        spath = synopsis_path(level_dir, zoom)
        if not os.path.exists(spath):
            continue
        exact = os.path.getsize(os.path.join(level_dir, name))
        syn = os.path.getsize(spath)
        per_zoom[zoom] = {"exact_bytes": exact, "synopsis_bytes": syn,
                          "ratio": round(exact / syn, 2)}
        exact_total += exact
        syn_total += syn
    return {"per_zoom": per_zoom, "exact_bytes": exact_total,
            "synopsis_bytes": syn_total,
            "bytes_ratio": round(exact_total / syn_total, 2)
            if syn_total else None}


def bench_decode(level_dir: str, iters: int) -> dict:
    """Decode latency at the largest synopsized zoom (the biggest dense
    grid) and the re-verified worst error stamp."""
    from heatmap_tpu_torch.io.sinks import LevelArraysSink
    from heatmap_tpu_torch.synopsis.build import load_synopses
    from heatmap_tpu_torch.synopsis.transform import grid_from_rows_np

    syn = load_synopses(level_dir)
    zoom = max(syn)
    samples = []
    for _ in range(iters):
        for pair in syn[zoom]:
            t0 = time.perf_counter()
            pair.decode()
            samples.append(1e3 * (time.perf_counter() - t0))
    samples.sort()

    # The stamp is the achieved error: a fresh decode against the exact
    # level must reproduce it exactly, every pair.
    levels = LevelArraysSink.load(level_dir)
    worst = 0.0
    for z, pairs in syn.items():
        cols = levels[z]
        users = np.asarray(cols["user"], str)
        tss = np.asarray(cols["timespan"], str)
        for pair in pairs:
            sel = (users == pair.user) & (tss == pair.timespan)
            grid = grid_from_rows_np(
                np.asarray(cols["row"])[sel], np.asarray(cols["col"])[sel],
                np.asarray(cols["value"])[sel], pair.n)
            achieved = float(np.abs(pair.decode() - grid).max())
            if achieved != pair.max_err:
                raise SystemExit(
                    f"error contract violated at z{z} "
                    f"({pair.user},{pair.timespan}): stamped "
                    f"{pair.max_err} != achieved {achieved}")
            worst = max(worst, pair.max_err)
    return {"zoom": zoom, "pairs": len(syn[zoom]),
            "decode_ms": {"p50": pct(samples, 0.50),
                          "p99": pct(samples, 0.99)},
            "max_err": worst, "verified": True}


class FixedChunks:
    """Re-chunk a materialized columnar batch into fixed micro-batches."""

    def __init__(self, cols: dict, size: int):
        self.cols = cols
        self.size = size

    def batches(self, batch_size: int = 1 << 20):
        n = len(self.cols["latitude"])
        for i in range(0, n, self.size):
            yield {c: v[i:i + self.size] for c, v in self.cols.items()}


def bench_early_serve(cols: dict, tmpdir: str, device) -> dict:
    """Provisional-to-exact lag through the real ingest loop."""
    from heatmap_tpu_torch import delta, ingest
    from heatmap_tpu_torch.obs import events
    from heatmap_tpu_torch.pipeline import BatchJobConfig
    from heatmap_tpu_torch.serve import TileCache, TileStore

    config = BatchJobConfig(detail_zoom=8, min_detail_zoom=4,
                            result_delta=2)
    root = os.path.join(tmpdir, "delta-store")
    delta.init_store(root)
    store, cache = TileStore(f"delta:{root}"), TileCache()
    events_path = os.path.join(tmpdir, "events.jsonl")
    log = events.EventLog(events_path)
    events.set_event_log(log)
    try:
        # compact_every=1 publishes a synopsis-bearing base after the
        # first tick, so every later tick serves early.
        ingest.run_ingest(
            root, FixedChunks(cols, 4096), config, store=store,
            cache=cache,
            ingest=ingest.IngestConfig(micro_batch=4096, queue_depth=2,
                                       compact_every=1),
            device=device)
    finally:
        events.set_event_log(None)
        log.close()
    records = events.read_events(events_path)
    lags, provisional = [], 0
    last_prov_ts = None
    for rec in records:
        if rec["event"] == "synopsis_built" and rec.get("provisional"):
            provisional += 1
            last_prov_ts = rec["ts"]
        elif rec["event"] == "delta_applied" and last_prov_ts is not None:
            lags.append(1e3 * (rec["ts"] - last_prov_ts))
            last_prov_ts = None
    lags.sort()
    return {"ticks": sum(r["event"] == "ingest_tick" for r in records),
            "provisional_publishes": provisional,
            "lag_ms": {"p50": pct(lags, 0.50), "p99": pct(lags, 0.99)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.bench_synopsis")
    ap.add_argument("--points", type=int, default=30_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--decode-iters", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("bench_synopsis"),
                    help="record file (default %(default)s)")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job

    device = resolve_device(args.device)
    obs.enable_metrics(True)
    tmpdir = tempfile.mkdtemp(prefix="benchsynopsis-")
    try:
        level_dir = os.path.join(tmpdir, "levels")
        config = BatchJobConfig(detail_zoom=10, min_detail_zoom=6,
                                result_delta=2)
        with open_sink(f"arrays-synopsis:{level_dir}") as sink:
            run_job(open_source(f"synthetic:{args.points}:{args.seed}"),
                    sink, config, device=device)
        compression = bench_compression(level_dir)
        print(json.dumps({"bytes_ratio": compression["bytes_ratio"]}),
              flush=True)
        decode = bench_decode(level_dir, args.decode_iters)
        print(json.dumps({"decode_ms": decode["decode_ms"],
                          "max_err": decode["max_err"]}), flush=True)
        cols = _materialize(f"synthetic:{args.points}:{args.seed + 1}")
        early = bench_early_serve(cols, tmpdir, device)
        print(json.dumps({"early_serve": early}), flush=True)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    record = {"bench": "synopsis", "points": args.points,
              "compression": compression, "decode": decode,
              "early_serve": early, **device_fields(device)}
    write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
