"""Temporal-plane bench: fold latency per cut, retraction throughput
and time-axis query latency.

The port's twin of ``tools/bench_temporal.py``. It builds a bucketed
delta store (four timed epochs, a bucketed compaction, one live epoch;
every applied batch's cascade on ``--device``), then measures:

- ``fold``: p50/p99 wall ms of a whole ``fold_levels`` pass per cut
  kind (``alltime``, ``as_of``, ``window``, ``decay``), nothing cached;
- ``serve``: p50/p99 of one ``ServeApp`` temporal tile request, the
  cache defeated by a new ``as_of`` cut per request, beside the
  all-time tile with the cache cleared;
- ``retract``: rows/s of a predicate retraction (journal scan, signed
  counter-batches, their cascades), byte-gated against a recompute over
  the survivors;
- ``growth``: p50/p99 of ``op=topk_growth`` and its stamped ``max_err``.

``alltime_byte_identical`` holds fold(all buckets + live) to the
un-bucketed overlay byte for byte. The exit code is 1 when either byte
gate fails. The record carries the JAX tool's keys (sorted, as it
writes them) plus ``device`` and, on a card, ``gpu_name`` and
``power_limit_w``.

    python -m heatmap_tpu_torch.tools.bench_temporal [--points 20000]
        [--iters 30] [--device cuda|cpu]
        [--out build/torch_bench/bench_temporal.json]
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

#: The JAX tool's record keys.
RECORD_KEYS = ("schema", "points", "iters", "build_seconds", "ref_edge",
               "alltime_byte_identical", "fold", "serve", "retract",
               "growth")


def _pct(vals: list, q: float):
    return pct(sorted(vals), q)


def timed_source(n: int, seed: int, t0: float, span: float) -> dict:
    """Synthetic GPS points with timestamps spread over [t0, t0+span),
    so compaction lands them across several buckets."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "latitude": rng.uniform(-60.0, 70.0, n),
        "longitude": rng.uniform(-179.0, 179.0, n),
        "user_id": ["u%d" % (j % 5) for j in range(n)],
        "timestamp": [str(t0 + span * j / n) for j in range(n)],
    }


def level_bytes(levels: list) -> list:
    import numpy as np

    out = []
    for lvl in levels:
        rec = {}
        for k, v in sorted(lvl.items()):
            if hasattr(v, "__len__") and not isinstance(v, str):
                a = np.asarray(v)
                rec[k] = (str(a.dtype), a.tobytes())
            else:
                rec[k] = v
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.bench_temporal",
        description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("bench_temporal"),
                    help="record file (default %(default)s)")
    args = ap.parse_args(argv)

    import numpy as np

    from heatmap_tpu_torch import delta
    from heatmap_tpu_torch.delta.compact import load_overlay_levels
    from heatmap_tpu_torch.delta.retract import parse_where, retract_predicate
    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.pipeline import BatchJobConfig
    from heatmap_tpu_torch.serve import ServeApp, TileCache, TileStore
    from heatmap_tpu_torch.temporal import fold as tfold
    from heatmap_tpu_torch.temporal import timequery

    device = resolve_device(args.device)
    cfg = BatchJobConfig(detail_zoom=10, min_detail_zoom=6, result_delta=2)
    tmp = tempfile.mkdtemp(prefix="bench-temporal-")
    try:
        root = os.path.join(tmp, "store")
        os.makedirs(root)
        tfold.ensure_config(root, width=3600.0, fanout=4, keep=4, tiers=3)

        # 4 timed epochs over ~20 tier-0 buckets, a bucketed compaction
        # and one live epoch on top: buckets and live units in one fold.
        per = max(1, args.points // 5)
        t0 = 1_500_000_000.0
        build_s = time.monotonic()
        for i in range(4):
            delta.apply_batch(root, delta.ColumnsSource(
                timed_source(per, i, t0 + i * 18_000, 18_000.0)), cfg,
                device=device)
        delta.compact(root, retention=10)
        delta.apply_batch(root, delta.ColumnsSource(
            timed_source(per, 9, t0 + 4 * 18_000, 18_000.0)), cfg,
            device=device)
        build_s = time.monotonic() - build_s

        ref = tfold.newest_edge(root, tfold.temporal_config(root))
        cuts = {
            "alltime": {},
            "as_of": {"as_of": t0 + 40_000},
            "window": {"window": 86_400.0},
            "decay": {"decay": 7200.0},
        }
        fold = {}
        gate = None
        for name, kw in cuts.items():
            times = []
            for _ in range(max(3, args.iters // 3)):
                it0 = time.monotonic()
                sel = tfold.select_fold(root, **kw)
                levels = tfold.fold_levels(
                    root, sel, decay_half_life=kw.get("decay"))
                times.append((time.monotonic() - it0) * 1000.0)
            fold[name] = {"ms": {"p50": _pct(times, 0.5),
                                 "p99": _pct(times, 0.99)},
                          "units": len(sel.buckets) + len(sel.live)
                          + (1 if sel.none else 0)}
            if name == "alltime":
                gate = level_bytes(levels) == level_bytes(
                    load_overlay_levels(root))

        # Serve: a new as_of cut per request, so every one is a miss,
        # beside the all-time tile on the same app.
        app = ServeApp(TileStore(f"delta:{root}"), TileCache())
        edges = sorted({b["t1"] for b in tfold.select_fold(root).buckets})
        serve = {}
        for leg, paths in {
            "temporal": [f"/tiles/default/2/1/1.json?as_of="
                         f"{edges[i % len(edges)]}"
                         for i in range(args.iters)],
            "alltime": ["/tiles/default/2/1/1.json"] * args.iters,
        }.items():
            times = []
            for path in paths:
                if leg == "alltime":
                    app.cache.clear()
                it0 = time.monotonic()
                res = app.handle("GET", path)
                times.append((time.monotonic() - it0) * 1000.0)
                assert res[0] in (200, 404), f"{path} -> {res[0]}"
            serve[leg] = {"ms": {"p50": _pct(times, 0.5),
                                 "p99": _pct(times, 0.99)}}

        # Retraction on a twin store: drop one of the five users end to
        # end, then gate against the survivors' recompute.
        rootr = os.path.join(tmp, "store-retract")
        roots = os.path.join(tmp, "store-survivors")
        for r in (rootr, roots):
            os.makedirs(r)
            tfold.ensure_config(r, width=3600.0, fanout=4, keep=4, tiers=3)
        rcols = timed_source(per, 17, t0, 18_000.0)
        keep = [j for j, u in enumerate(rcols["user_id"]) if u != "u0"]
        scols = {k: ([v[j] for j in keep] if isinstance(v, list)
                     else np.asarray(v)[keep]) for k, v in rcols.items()}
        delta.apply_batch(rootr, delta.ColumnsSource(rcols), cfg,
                          device=device)
        delta.apply_batch(roots, delta.ColumnsSource(scols), cfg,
                          device=device)
        it0 = time.monotonic()
        summary = retract_predicate(rootr, parse_where(["user=u0"]),
                                    device=device)
        retract_s = time.monotonic() - it0
        retract = {
            "rows": summary["rows"], "batches": summary["batches"],
            "scanned": summary["scanned"], "seconds": round(retract_s, 3),
            "rows_per_s": (summary["rows"] / retract_s) if retract_s
            else None,
            "byte_identical": level_bytes(load_overlay_levels(rootr))
            == level_bytes(load_overlay_levels(roots)),
        }

        # Time-axis queries: repeated topk_growth evaluations.
        times = []
        doc = None
        for _ in range(max(3, args.iters // 3)):
            it0 = time.monotonic()
            doc = timequery.topk_growth(root, user="all",
                                        timespan="alltime", zoom=8,
                                        window=86_400.0, k=20,
                                        coeffs=timequery.DEFAULT_COEFFS)
            times.append((time.monotonic() - it0) * 1000.0)
        growth = {"ms": {"p50": _pct(times, 0.5), "p99": _pct(times, 0.99)},
                  "slots": doc["slots"], "max_err": doc["max_err"],
                  "cells": len(doc["cells"])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = {
        "schema": "heatmap-tpu.bench_temporal.v1",
        "points": args.points, "iters": args.iters,
        "build_seconds": round(build_s, 1), "ref_edge": ref,
        "alltime_byte_identical": bool(gate),
        "fold": fold, "serve": serve, "retract": retract,
        "growth": growth,
        **device_fields(device),
    }
    write_record(args.out, out, sort_keys=True)
    print(json.dumps({k: out[k] for k in
                      ("alltime_byte_identical", "fold", "retract",
                       "growth")}, indent=2, sort_keys=True))
    if not gate or not retract["byte_identical"]:
        print("bench_temporal: BYTE GATE FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
