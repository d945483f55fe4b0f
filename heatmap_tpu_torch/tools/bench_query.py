"""Range-query bench: ``/query`` latency, integral against fall-through,
and fleet-router throughput.

The port's twin of ``tools/bench_query.py``. It builds an
``arrays-integral:`` store with ``run_job`` on ``--device`` from
uniformly spread points (the stock clustered mixture leaves the coarse
levels nearly empty, so the fall-through would cost less than a
request), then measures:

- ``direct``: per op, p50/p99 of one ``ServeApp`` ``/query`` over
  distinct random rects (every request a miss) on the integral path,
  beside the same rects against a copy with its integral artifacts
  stripped (the exact-rows fall-through); ``speedup_p99`` is their
  quotient;
- ``router``: requests/s and latency of ``op=sum`` through a
  thread-mode ``FleetSupervisor`` of ``--backends`` backends (the
  placement key colocates every op over one layer, zoom and bbox);
- ``bytes``: integral artifact bytes per zoom beside the exact level
  bytes they index.

The record carries the JAX tool's keys plus ``device`` and, on a card,
``gpu_name`` and ``power_limit_w``.

    python -m heatmap_tpu_torch.tools.bench_query [--points 200000]
        [--iters 300] [--ops sum,topk,quantile] [--device cuda|cpu]
        [--out build/torch_bench/bench_query.json]
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
RECORD_KEYS = ("bench", "points", "zoom", "iters", "direct", "router",
               "bytes")


class UniformSource:
    """Uniform world-spanning GPS points, a pure function of the seed
    and the chunk index."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = int(n), int(seed)

    def close(self) -> None:
        pass

    def batches(self, batch_size: int = 1 << 16):
        import numpy as np

        done = 0
        chunk = 0
        while done < self.n:
            m = min(self.n - done, 1 << 16)
            rng = np.random.default_rng([self.seed, chunk])
            yield {
                "latitude": rng.uniform(-60.0, 70.0, m),
                "longitude": rng.uniform(-179.0, 179.0, m),
                "user_id": ["u%d" % (j % 7) for j in range(done, done + m)],
                "timestamp": [1_500_000_000 + j
                              for j in range(done, done + m)],
                "source": ["gps"] * m,
            }
            done += m
            chunk += 1


def _ops_list(text: str) -> list:
    """Comma-separated ops, each checked by ``analytics.validate_op``."""
    from heatmap_tpu_torch.analytics import validate_op

    ops = [validate_op(tok.strip()) for tok in text.split(",") if tok.strip()]
    if not ops:
        raise ValueError(f"--ops got no operations in {text!r}")
    return ops


def _top_k(text: str) -> int:
    k = int(text)
    if k < 1:
        raise ValueError(f"--top-k must be >= 1, got {k}")
    return k


def _quantile_q(text: str) -> float:
    q = float(text)
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"--quantile-q must be in [0, 1], got {q}")
    return q


def _rects(rng, n: int, count: int) -> list:
    out = []
    for _ in range(count):
        r0, r1 = sorted(int(v) for v in rng.integers(0, n, 2))
        c0, c1 = sorted(int(v) for v in rng.integers(0, n, 2))
        out.append((r0, c0, r1, c1))
    return out


def _query_path(z: int, rect, op: str, k: int, q: float) -> str:
    r0, c0, r1, c1 = rect
    path = f"/query?layer=default&z={z}&bbox={c0},{r0},{c1},{r1}&op={op}"
    if op == "topk":
        path += f"&k={k}"
    elif op == "quantile":
        path += f"&q={q}"
    return path


def _time_requests(app, paths: list) -> list:
    samples = []
    for path in paths:
        t0 = time.perf_counter()
        res = app.handle("GET", path)
        dt = 1e3 * (time.perf_counter() - t0)
        if res[0] != 200:
            raise SystemExit(f"bench query failed {res[0]}: {path} "
                             f"{res[2][:200]!r}")
        samples.append(dt)
    samples.sort()
    return samples


def bench_direct(level_dir: str, stripped_dir: str, z: int, args) -> dict:
    """Integral against fall-through over the same rects."""
    import numpy as np

    from heatmap_tpu_torch.serve import ServeApp, TileStore

    rng = np.random.default_rng(args.seed + 1)
    rects = _rects(rng, 1 << z, args.iters)
    out = {}
    for op in args.ops:
        paths = [_query_path(z, r, op, args.top_k, args.quantile_q)
                 for r in rects]
        # A fresh app per leg: equal cold caches, every rect a miss.
        fast = _time_requests(ServeApp(TileStore(f"arrays:{level_dir}")),
                              paths)
        slow = _time_requests(
            ServeApp(TileStore(f"arrays:{stripped_dir}")), paths)
        row = {
            "integral_ms": {"p50": pct(fast, 0.50), "p99": pct(fast, 0.99)},
            "fallback_ms": {"p50": pct(slow, 0.50), "p99": pct(slow, 0.99)},
        }
        if row["integral_ms"]["p99"]:
            row["speedup_p99"] = round(
                row["fallback_ms"]["p99"] / row["integral_ms"]["p99"], 2)
        out[op] = row
    return out


def bench_router(level_dir: str, z: int, args) -> dict:
    """``op=sum`` requests/s and latency through a thread-mode fleet."""
    import numpy as np

    from heatmap_tpu_torch.serve import FleetSupervisor, TileStore, route_key

    rng = np.random.default_rng(args.seed + 2)
    rects = _rects(rng, 1 << z, 64)
    paths = [_query_path(z, r, "sum", args.top_k, args.quantile_q)
             for r in rects]
    # Every op over one (layer, z, bbox) lands on one backend.
    assert route_key(paths[0]) == route_key(
        _query_path(z, rects[0], "topk", args.top_k, args.quantile_q))
    sup = FleetSupervisor(
        None, args.backends, mode="thread",
        store_factory=lambda: TileStore(f"arrays:{level_dir}"),
        cache_bytes=32 << 20, probe_interval_s=0.1,
        monitor_interval_s=0.05)
    try:
        sup.start()
        for path in paths:  # warm every backend's route and cache
            sup.router.handle("GET", path)
        samples = []
        t0 = time.perf_counter()
        for i in range(args.iters):
            path = paths[i % len(paths)]
            s0 = time.perf_counter()
            res = sup.router.handle("GET", path)
            samples.append(1e3 * (time.perf_counter() - s0))
            if res[0] != 200:
                raise SystemExit(f"router query failed {res[0]}: {path}")
        wall = time.perf_counter() - t0
    finally:
        sup.stop()
    samples.sort()
    return {"backends": args.backends, "requests": args.iters,
            "rps": round(args.iters / wall, 1),
            "latency_ms": {"p50": pct(samples, 0.50),
                           "p99": pct(samples, 0.99)}}


def bench_bytes(level_dir: str) -> dict:
    """Integral artifact bytes per zoom beside the exact level bytes."""
    per_zoom = {}
    for name in sorted(os.listdir(level_dir)):
        if not (name.startswith("integral-z") and name.endswith(".npz")):
            continue
        zoom = int(name[len("integral-z"):len("integral-z") + 2])
        level = os.path.join(level_dir, f"level_z{zoom:02d}.npz")
        per_zoom[zoom] = {
            "integral_bytes": os.path.getsize(os.path.join(level_dir, name)),
            "exact_bytes": (os.path.getsize(level)
                            if os.path.exists(level) else None),
        }
    return per_zoom


def build_store(level_dir: str, points: int, seed: int, device) -> None:
    """The integral store the bench reads: ``run_job`` on ``device``."""
    from heatmap_tpu_torch.io import open_sink
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job

    config = BatchJobConfig(detail_zoom=10, min_detail_zoom=6,
                            result_delta=2)
    with open_sink(f"arrays-integral:{level_dir}") as sink:
        run_job(UniformSource(points, seed), sink, config, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="heatmap_tpu_torch.tools.bench_query")
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--iters", type=int, default=300,
                    help="requests per op and per router window")
    ap.add_argument("--ops", type=_ops_list, default=None,
                    help="comma-separated /query ops to bench "
                    "(default: all)")
    ap.add_argument("--top-k", type=_top_k, default=10)
    ap.add_argument("--quantile-q", type=_quantile_q, default=0.5)
    ap.add_argument("--backends", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("bench_query"),
                    help="record file (default %(default)s)")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.analytics import VALID_OPS
    from heatmap_tpu_torch.devices import resolve_device

    device = resolve_device(args.device)
    if args.ops is None:
        args.ops = list(VALID_OPS)
    obs.enable_metrics(True)
    tmpdir = tempfile.mkdtemp(prefix="benchquery-")
    try:
        level_dir = os.path.join(tmpdir, "levels")
        build_store(level_dir, args.points, args.seed, device)
        # The A/B twin: the same exact rows, integral artifacts stripped.
        stripped = os.path.join(tmpdir, "levels-stripped")
        shutil.copytree(level_dir, stripped)
        for name in os.listdir(stripped):
            if name.startswith("integral-"):
                os.remove(os.path.join(stripped, name))
        z = max(int(n[len("integral-z"):len("integral-z") + 2])
                for n in os.listdir(level_dir)
                if n.startswith("integral-z"))

        direct = bench_direct(level_dir, stripped, z, args)
        print(json.dumps({"zoom": z, "direct": {
            op: {"integral_p99": row["integral_ms"]["p99"],
                 "speedup_p99": row.get("speedup_p99")}
            for op, row in direct.items()}}), flush=True)
        router = bench_router(level_dir, z, args)
        print(json.dumps({"router_rps": router["rps"],
                          "router_p99": router["latency_ms"]["p99"]}),
              flush=True)
        artifact_bytes = bench_bytes(level_dir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    record = {"bench": "query", "points": args.points, "zoom": z,
              "iters": args.iters, "direct": direct, "router": router,
              "bytes": artifact_bytes, **device_fields(device)}
    write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
