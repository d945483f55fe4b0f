"""Continuous-ingest bench: throughput and ingest-to-servable lag,
bucketed against exact padding.

The port's twin of ``tools/bench_ingest.py``. For each micro-batch size
it drains the same deterministically jittered synthetic stream (batch
sizes vary tick to tick, as a standing loop sees them) through
``ingest.run_ingest`` twice, once with exact padding and once with the
pow2 buckets (``pipeline/bucketing.py``), publishing every tick to a
live serve store. Per cell:

- ``pts_per_s``: applied points over the loop's wall seconds;
- ``lag_ms``: micro-batch enqueued -> tiles invalidated, p50/p99 (the
  ``lag_s`` of each ``ingest_tick`` event);
- ``tick_ms``: apply + publish, p50/p99;
- ``compiles``: distinct cascade signatures of the run
  (``bucketing.cache_stats()["misses"]``, the JAX package's compile
  count, mirrored);
- ``feed_overlap_pct`` and ``feeder_depth_hwm``: the double-buffered
  feeder's overlap and queue high-water mark.

The record carries the JAX tool's keys plus ``device`` and, on a card,
``gpu_name`` and ``power_limit_w``.

    python -m heatmap_tpu_torch.tools.bench_ingest [--points 40000]
        [--micro-batches 512,2048,8192] [--device cuda|cpu]
        [--out build/torch_bench/bench_ingest.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from heatmap_tpu_torch.tools._common import (default_out, device_fields,
                                             write_record)

#: The JAX tool's record keys and per-cell row keys, in its order.
RECORD_KEYS = ("bench", "points", "micro_batches", "results", "run_report")
RESULT_KEYS = ("micro_batch", "mode", "ticks", "points", "pts_per_s",
               "lag_ms", "tick_ms", "compiles", "cache_hits",
               "keys_invalidated", "max_queue_depth", "feed_overlap_pct",
               "feeder_depth_hwm")

#: Tick-to-tick batch size multipliers (deterministic jitter cycle).
JITTER = (1.0, 0.62, 0.91, 0.55, 0.84, 0.73)


class JitteredSource:
    """Re-chunk a materialized columnar batch into deterministically
    varying micro-batch sizes: tick k gets ``batch_size * JITTER[k %
    len(JITTER)]`` rows. Same points, same order, every drain."""

    def __init__(self, cols: dict):
        self.cols = cols

    def batches(self, batch_size: int = 1 << 20):
        n = len(self.cols["latitude"])
        i = k = 0
        while i < n:
            take = max(1, min(n - i,
                              int(batch_size * JITTER[k % len(JITTER)])))
            yield {c: v[i:i + take] for c, v in self.cols.items()}
            i += take
            k += 1


def _materialize(spec: str) -> dict:
    """Drain a source spec into one columnar dict."""
    from heatmap_tpu_torch.io import open_source

    cols: dict = {}
    for batch in open_source(spec).batches(1 << 20):
        for c, v in batch.items():
            cols.setdefault(c, []).extend(v)
    return cols


def _pct(sorted_vals: list, q: float) -> float | None:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def bench_cell(cols: dict, micro_batch: int, mode: str, tmpdir: str,
               device) -> dict:
    from heatmap_tpu_torch import delta, ingest
    from heatmap_tpu_torch.obs import events
    from heatmap_tpu_torch.pipeline import BatchJobConfig, bucketing
    from heatmap_tpu_torch.serve import TileCache, TileStore

    config = BatchJobConfig(detail_zoom=11, min_detail_zoom=5,
                            result_delta=3, pad_bucketing=mode)
    root = os.path.join(tmpdir, f"store-{micro_batch}-{mode}")
    delta.init_store(root)
    store, cache = TileStore(f"delta:{root}"), TileCache()
    events_path = os.path.join(tmpdir, f"events-{micro_batch}-{mode}.jsonl")
    bucketing.reset_cache_stats()
    log = events.EventLog(events_path)
    events.set_event_log(log)
    t0 = time.perf_counter()
    try:
        stats = ingest.run_ingest(
            root, JitteredSource(cols), config, store=store, cache=cache,
            ingest=ingest.IngestConfig(micro_batch=micro_batch,
                                       queue_depth=4, compact_every=0),
            device=device)
    finally:
        events.set_event_log(None)
        log.close()
    wall_s = time.perf_counter() - t0
    ticks = [r for r in events.read_events(events_path)
             if r["event"] == "ingest_tick"]
    lags = sorted(1e3 * float(r["lag_s"]) for r in ticks)
    secs = sorted(1e3 * float(r["seconds"]) for r in ticks)
    cache_stats = bucketing.cache_stats()
    shutil.rmtree(root, ignore_errors=True)
    return {
        "micro_batch": micro_batch,
        "mode": mode,
        "ticks": stats.ticks,
        "points": stats.points,
        "pts_per_s": round(stats.points / wall_s, 1) if wall_s else None,
        "lag_ms": {"p50": _pct(lags, 0.50), "p99": _pct(lags, 0.99)},
        "tick_ms": {"p50": _pct(secs, 0.50), "p99": _pct(secs, 0.99)},
        "compiles": cache_stats["misses"],
        "cache_hits": cache_stats["hits"],
        "keys_invalidated": stats.keys_invalidated,
        "max_queue_depth": stats.max_queue_depth,
        "feed_overlap_pct": round(stats.feed_overlap_pct, 1),
        "feeder_depth_hwm": stats.feeder_depth_hwm,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="heatmap_tpu_torch.tools.bench_ingest")
    ap.add_argument("--points", type=int, default=40_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--micro-batches", default="512,2048,8192",
                    help="comma list of micro-batch sizes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("bench_ingest"),
                    help="record file (default %(default)s)")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.utils.trace import get_tracer

    device = resolve_device(args.device)
    obs.enable_metrics(True)
    cols = _materialize(f"synthetic:{args.points}:{args.seed}")
    sizes = [int(b) for b in args.micro_batches.split(",") if b.strip()]
    tmpdir = tempfile.mkdtemp(prefix="benchingest-")
    results = []
    try:
        for micro_batch in sizes:
            # Exact first, as the JAX tool orders them.
            for mode in ("exact", "pow2"):
                row = bench_cell(cols, micro_batch, mode, tmpdir, device)
                print(json.dumps({k: row[k] for k in
                                  ("micro_batch", "mode", "pts_per_s",
                                   "lag_ms", "compiles")}), flush=True)
                results.append(row)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    record = {
        "bench": "ingest",
        "points": args.points,
        "micro_batches": sizes,
        "results": results,
        "run_report": obs.build_run_report(tracer=get_tracer(),
                                           registry=obs.get_registry()),
        **device_fields(device),
    }
    write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
