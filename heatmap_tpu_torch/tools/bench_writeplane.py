"""Write-plane bench: multi-writer throughput and enqueue-to-servable
lag at 1, 2 and 4 writers.

The port's twin of ``tools/bench_writeplane.py``. Each cell drains the
same hotspot-clustered synthetic stream through
``writeplane.run_plane_ingest`` with N pump threads (each routed
sub-batch's cascade on ``--device``: 2-4 threads launch the segment
reduce at once, counted through ``_build.count_launch``), then
byte-gates the plane against a single-writer delta store fed the same
micro-batches. Per cell:

- ``pts_per_s``: completed points over the drain's wall seconds;
- ``lag_s``: micro-batch enqueued at the router -> covered by a flipped
  manifest epoch, p50/p99 (``PlaneStats.lags_s``);
- ``publishes``: manifest epochs flipped during the drain;
- ``byte_identical``: every servable JSON tile equal to the reference
  store's (the exit code is 1 when a cell fails it).

The record carries the JAX tool's keys (sorted, as it writes them) plus
``device`` and, on a card, ``gpu_name`` and ``power_limit_w``.

    python -m heatmap_tpu_torch.tools.bench_writeplane [--points 20000]
        [--seed 7] [--writers 1,2,4] [--micro-batch 2048]
        [--device cuda|cpu] [--out build/torch_bench/bench_writeplane.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from heatmap_tpu_torch.tools._common import (default_out, device_fields, pct,
                                             write_record)

#: The JAX tool's record keys and per-cell row keys.
RECORD_KEYS = ("bench", "points", "micro_batch", "tiles", "results")
RESULT_KEYS = ("writers", "batches", "completed", "failed", "points",
               "pts_per_s", "lag_s", "publishes", "byte_identical",
               "wall_s")


def _config():
    from heatmap_tpu_torch.pipeline import BatchJobConfig

    # Routed sub-batch sizes vary tick to tick, so the cells run the
    # pow2 buckets (byte-neutral), as the JAX tool does.
    return BatchJobConfig(detail_zoom=11, min_detail_zoom=5,
                          result_delta=3, pad_bucketing="pow2",
                          pad_bucket_min=1 << 8)


def collect_docs(store) -> dict:
    """Every servable JSON tile, ``{(layer, z, x, y): bytes}``, listed
    from the levels' Morton codes, so the stores must agree on which
    tiles exist as well as on their bytes."""
    import numpy as np

    from heatmap_tpu_torch.serve.render import tile_json_bytes
    from heatmap_tpu_torch.tilemath.morton import morton_decode_np

    docs = {}
    for name, layer in store.layers.items():
        if name == "default":
            continue
        shift = 2 * layer.result_delta
        for want, level in layer.levels.items():
            z = want - layer.result_delta
            if z < 0:
                continue
            rows, cols = morton_decode_np(np.unique(level.codes >> shift))
            for r, c in zip(rows, cols):
                docs[(name, z, int(c), int(r))] = tile_json_bytes(
                    layer, z, int(c), int(r))
    return docs


def reference_docs(spec: str, micro_batch: int, root: str, device) -> dict:
    """The byte gate: a single-writer delta store over the same
    micro-batches."""
    from heatmap_tpu_torch import delta
    from heatmap_tpu_torch.io import open_source
    from heatmap_tpu_torch.serve import TileStore

    config = _config()
    for batch in open_source(spec).batches(micro_batch):
        delta.apply_batch(root, delta.ColumnsSource(batch), config,
                          device=device)
    return collect_docs(TileStore(f"delta:{root}"))


def bench_cell(spec: str, n_writers: int, micro_batch: int, tmpdir: str,
               ref_docs: dict, device) -> dict:
    from heatmap_tpu_torch.io import open_source
    from heatmap_tpu_torch.serve import TileStore
    from heatmap_tpu_torch.writeplane import (PlaneConfig, WritePlane,
                                              run_plane_ingest)

    root = os.path.join(tmpdir, f"plane-{n_writers}")
    plane = WritePlane(root, _config(), PlaneConfig(n_writers=n_writers),
                       device=device)
    t0 = time.perf_counter()
    stats = run_plane_ingest(plane, open_source(spec),
                             micro_batch=micro_batch)
    wall_s = time.perf_counter() - t0
    docs = collect_docs(TileStore(f"writeplane:{root}"))
    lags = sorted(stats.lags_s)
    shutil.rmtree(root, ignore_errors=True)
    return {
        "writers": n_writers,
        "batches": stats.batches,
        "completed": stats.completed,
        "failed": stats.failed,
        "points": stats.points,
        "pts_per_s": round(stats.points / wall_s, 1) if wall_s else None,
        "lag_s": {"p50": pct(lags, 0.50), "p99": pct(lags, 0.99)},
        "publishes": stats.publishes,
        "byte_identical": docs == ref_docs,
        "wall_s": round(wall_s, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.bench_writeplane")
    ap.add_argument("--points", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--writers", default="1,2,4",
                    help="comma list of writer counts")
    ap.add_argument("--micro-batch", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("bench_writeplane"),
                    help="record file (default %(default)s)")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch.devices import resolve_device

    device = resolve_device(args.device)
    spec = f"synthetic:{args.points}:{args.seed}"
    counts = [int(w) for w in args.writers.split(",") if w.strip()]
    tmpdir = tempfile.mkdtemp(prefix="benchwriteplane-")
    try:
        ref_docs = reference_docs(spec, args.micro_batch,
                                  os.path.join(tmpdir, "ref"), device)
        results = []
        for n_writers in counts:  # 1 first, as in the JAX tool
            row = bench_cell(spec, n_writers, args.micro_batch, tmpdir,
                             ref_docs, device)
            print(json.dumps({k: row[k] for k in
                              ("writers", "pts_per_s", "lag_s",
                               "byte_identical")}), flush=True)
            results.append(row)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    record = {
        "bench": "writeplane",
        "points": args.points,
        "micro_batch": args.micro_batch,
        "tiles": len(ref_docs),
        "results": results,
        **device_fields(device),
    }
    write_record(args.out, record, sort_keys=True)
    return 0 if all(r["byte_identical"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
