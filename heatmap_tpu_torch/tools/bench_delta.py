"""Incremental delta apply against full recompute.

The port's twin of ``tools/bench_delta.py``. For each base:delta size
ratio it builds a delta store whose base holds ``--base-points``
synthetic points (compacted, so the overlay starts clean), then times
two ways of absorbing one new batch of ``base_points / ratio`` points:

- **full**: the reference's shape, the whole batch job re-run over the
  union of old and new points (``run_job`` into a fresh columnar
  artifact);
- **incremental**: ``delta.apply_batch``, which journals the batch,
  cascades only the new points and writes a delta artifact the serve
  overlay merges on read.

Both run in this process on ``--device``. The record carries the JAX
tool's keys (the headline rows, the folded ``run_report`` and the
span-tree digest) plus ``device`` and, on a card, ``gpu_name`` and
``power_limit_w``.

    python -m heatmap_tpu_torch.tools.bench_delta [--base-points 200000]
        [--ratios 100,20,5] [--detail-zoom 12] [--device cuda|cpu]
        [--out build/torch_bench/bench_delta.json]
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
                                             summarize_trace, synchronize,
                                             write_record)

#: The JAX tool's record keys and per-ratio row keys, in its order.
RECORD_KEYS = ("bench", "base_points", "detail_zoom", "results",
               "run_report", "trace")
RESULT_KEYS = ("ratio", "base_points", "delta_points", "base_build_s",
               "full_recompute_s", "incremental_apply_s", "speedup",
               "full_rows", "delta_rows", "affected_keys")


class _Chain:
    """Concatenate sources: the union job reads old + new points as one
    stream (synthetic sources are deterministic, so re-opening them
    replays the points the store ingested)."""

    def __init__(self, *sources):
        self.sources = sources

    def batches(self, batch_size: int = 1 << 20):
        for src in self.sources:
            yield from src.batches(batch_size)


def bench_ratio(ratio: int, base_points: int, config, tmpdir: str,
                device) -> dict:
    from heatmap_tpu_torch import delta
    from heatmap_tpu_torch.io import open_source
    from heatmap_tpu_torch.io.sinks import LevelArraysSink
    from heatmap_tpu_torch.pipeline import run_job

    delta_points = max(1, base_points // ratio)
    base_spec = f"synthetic:{base_points}:7"
    delta_spec = f"synthetic:{delta_points}:11"
    root = os.path.join(tmpdir, f"store-{ratio}")

    # The base build rides the delta engine itself (apply + compact),
    # and also builds the kernels, so neither timed path pays that.
    t0 = time.perf_counter()
    delta.apply_batch(root, open_source(base_spec), config, device=device)
    delta.compact(root, retention=0)
    base_s = time.perf_counter() - t0

    # Full recompute over the union (the reference's only option).
    full_dir = os.path.join(tmpdir, f"full-{ratio}")
    t0 = time.perf_counter()
    full_stats = run_job(
        _Chain(open_source(base_spec), open_source(delta_spec)),
        LevelArraysSink(full_dir), config, device=device)
    synchronize(device)
    full_s = time.perf_counter() - t0

    # Incremental: journal + cascade only the new points, after one
    # warm-up apply of the same size (another seed).
    delta.apply_batch(root, open_source(f"synthetic:{delta_points}:13"),
                      config, device=device)
    t0 = time.perf_counter()
    res = delta.apply_batch(root, open_source(delta_spec), config,
                            device=device)
    synchronize(device)
    incr_s = time.perf_counter() - t0

    shutil.rmtree(full_dir, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    return {
        "ratio": ratio,
        "base_points": base_points,
        "delta_points": delta_points,
        "base_build_s": round(base_s, 3),
        "full_recompute_s": round(full_s, 3),
        "incremental_apply_s": round(incr_s, 3),
        "speedup": round(full_s / incr_s, 2) if incr_s else None,
        "full_rows": int(full_stats.get("rows", 0))
        if isinstance(full_stats, dict) else None,
        "delta_rows": res.rows,
        "affected_keys": len(res.affected_keys),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="heatmap_tpu_torch.tools.bench_delta")
    ap.add_argument("--base-points", type=int, default=200_000)
    ap.add_argument("--ratios", default="100,20,5",
                    help="comma list of base:delta ratios")
    ap.add_argument("--detail-zoom", type=int, default=12)
    ap.add_argument("--min-detail-zoom", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("bench_delta"),
                    help="record file (default %(default)s)")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.obs import tracing
    from heatmap_tpu_torch.pipeline import BatchJobConfig
    from heatmap_tpu_torch.utils.trace import get_tracer

    device = resolve_device(args.device)
    obs.enable_metrics(True)
    collector = tracing.enable_tracing()
    config = BatchJobConfig(detail_zoom=args.detail_zoom,
                            min_detail_zoom=args.min_detail_zoom)
    ratios = [int(r) for r in args.ratios.split(",") if r.strip()]
    tmpdir = tempfile.mkdtemp(prefix="benchdelta-")
    results = []
    try:
        for ratio in ratios:
            row = bench_ratio(ratio, args.base_points, config, tmpdir,
                              device)
            print(json.dumps({k: row[k] for k in
                              ("ratio", "full_recompute_s",
                               "incremental_apply_s", "speedup")}),
                  flush=True)
            results.append(row)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    record = {
        "bench": "delta",
        "base_points": args.base_points,
        "detail_zoom": args.detail_zoom,
        "results": results,
        "run_report": obs.build_run_report(tracer=get_tracer(),
                                           registry=obs.get_registry()),
        "trace": summarize_trace(collector.to_chrome()),
        **device_fields(device),
    }
    write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
