"""End-to-end batch-job benchmark: HMPB ingest -> cascade -> egress.

The port's twin of ``tools/bench_job.py``. It writes an HMPB file of
synthetic GPS points (a hot cluster and a fringe, a few hundred users
with rt-/x- routing; the JAX tool's generator, so the same bytes), runs
``run_job_fast`` on it end to end and prints the tracer's stage balance
and a points/s headline: mmap ingest, group routing, the z21
composite-key cascade, decode/finalize and egress.

Each measurement runs in a SUBPROCESS (``--single`` re-exec): a child
that crashes costs only its measurement, its stderr goes to
``bj_stderr.log`` beside the record, and the parent halves ``--n`` (a
fresh input of the new size for every backend) until a row lands or
``--min-n`` is passed.

    python -m heatmap_tpu_torch.tools.bench_job [--n 20000000]
        [--egress arrays|json|none] [--runs 1]
        [--cascade-backend scatter|partitioned|both] [--trace-stages]
        [--device cuda|cpu] [--out build/torch_bench/bench_job.json]

``--trace-stages`` adds sort / segment-reduce attribution to the stage
report (the card is synchronised at each of those spans). The record
file holds every landed measurement under ``results``; each has the JAX
tool's keys plus ``device`` and, on a card, ``gpu_name`` and
``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from heatmap_tpu_torch.tools._common import (default_out, device_fields,
                                             summarize_trace, write_record)

#: The keys of one measurement's record in the JAX tool, in its order.
RECORD_KEYS = ("run", "device", "n_points", "cascade_backend", "egress",
               "total_s", "pts_per_s", "stages", "out", "run_report",
               "trace")


def synth_hmpb(path: str, n: int, seed: int = 0) -> str:
    """The JAX tool's synthetic HMPB file of ``n`` points."""
    from heatmap_tpu_torch.io.hmpb import write_hmpb

    rng = np.random.default_rng(seed)
    n_hot = n // 4
    lat = np.concatenate([47.6 + rng.normal(0, 0.5, n - n_hot),
                          47.6 + rng.normal(0, 0.02, n_hot)])
    lon = np.concatenate([-122.3 + rng.normal(0, 0.7, n - n_hot),
                          -122.3 + rng.normal(0, 0.03, n_hot)])
    # Routed ids against a names table shaped like production: a few
    # hundred users, one pooled "route" group, x-excluded rows (-1).
    names = ["all"] + [f"user{i}" for i in range(200)] + ["route"]
    routed = rng.integers(1, len(names), n, dtype=np.int32)
    routed[rng.random(n) < 0.05] = -1  # x- excluded
    ts = rng.integers(1_500_000_000_000, 1_700_000_000_000, n, dtype=np.int64)
    background = (rng.random(n) < 0.02).astype(np.uint8)
    return write_hmpb(path, lat, lon, routed, names,
                      timestamp=ts, background=background)


def run_single(args) -> int:
    """One measurement in THIS process: run the job once over the
    prepared HMPB file and print the result JSON line."""
    import torch

    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.io.hmpb import HMPBSource
    from heatmap_tpu_torch.io.sinks import LevelArraysSink, MemorySink
    from heatmap_tpu_torch.obs import tracing
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job_fast
    from heatmap_tpu_torch.utils.trace import (enable_stage_tracing,
                                               get_tracer)

    device = resolve_device(args.device)
    if args.trace_stages:
        enable_stage_tracing(True)
    # Metrics ride along (counters and histograms, no event log, so no
    # per-span I/O in the timed region); the folded run report lands in
    # the record.
    obs.enable_metrics(True)
    backend = args.cascade_backend
    config = (BatchJobConfig() if backend is None
              else BatchJobConfig(cascade_backend=backend))
    tracer = get_tracer()
    tracer.reset()
    collector = tracing.enable_tracing()
    if args.egress == "arrays":
        sink = LevelArraysSink(os.path.join(
            os.path.dirname(args.hmpb), f"levels{args.run}-{backend}"))
    elif args.egress == "json":
        sink = MemorySink()
    else:
        sink = None
    t0 = time.perf_counter()
    out = run_job_fast(HMPBSource(args.hmpb), sink=sink, config=config,
                       device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    stages = {
        name: round(r["total_s"], 3)
        for name, r in sorted(tracer.report().items())
    }
    obs.sample_device_memory()
    fields = device_fields(device)
    print(json.dumps({
        "run": args.run,
        "device": fields.pop("device"),
        "n_points": args.n,
        "cascade_backend": backend or "default",
        "egress": args.egress,
        "total_s": round(dt, 2),
        "pts_per_s": round(args.n / dt),
        "stages": stages,
        "out": (len(out) if hasattr(out, "__len__") else str(out)[:80]),
        "run_report": obs.build_run_report(tracer=tracer,
                                           registry=obs.get_registry()),
        "trace": summarize_trace(collector.to_chrome()),
        **fields,
    }, default=str), flush=True)
    return 0


def _drive_one(args, hmpb: str, n: int, run: int, backend: str | None,
               stderr_log: str):
    """Run one measurement in a subprocess; return its record or None.
    The child's result line passes through to stdout; its stderr
    appends to ``stderr_log``."""
    cmd = [sys.executable, "-m", "heatmap_tpu_torch.tools.bench_job",
           "--single", "--hmpb", hmpb, "--n", str(n), "--run", str(run),
           "--egress", args.egress, "--device", args.device]
    if backend is not None:
        cmd += ["--cascade-backend", backend]
    if args.trace_stages:
        cmd.append("--trace-stages")
    # The child imports this package from the checkout it came from.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    os.makedirs(os.path.dirname(stderr_log) or ".", exist_ok=True)
    with open(stderr_log, "a") as ef:
        ef.write(f"\n===== bench_job attempt at {time.strftime('%F %T')} "
                 f"backend={backend} n={n} =====\n")
        ef.flush()
        try:
            r = subprocess.run(cmd, timeout=args.child_timeout, env=env,
                               stdout=subprocess.PIPE, stderr=ef, text=True)
        except subprocess.TimeoutExpired:
            ef.write(f"[bench_job] child timed out after "
                     f"{args.child_timeout}s\n")
            return None
    rec = None
    for line in r.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            print(line, flush=True)
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "pts_per_s" in parsed:
                rec = parsed
    if r.returncode != 0:
        print(json.dumps({"crashed": True, "rc": r.returncode,
                          "backend": backend, "n": n,
                          "stderr_log": stderr_log}), flush=True)
        return None
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="heatmap_tpu_torch.tools.bench_job")
    ap.add_argument("--n", type=int, default=20_000_000)
    ap.add_argument("--egress", choices=("arrays", "json", "none"),
                    default="arrays")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--cascade-backend", default=None,
                    choices=("scatter", "partitioned", "both"),
                    help="cascade reduction backend; 'both' measures each "
                    "backend on the same input file")
    ap.add_argument("--trace-stages", action="store_true",
                    help="per-stage cascade attribution (sort / "
                    "segment-reduce) in the stage report; synchronises "
                    "the card at each")
    ap.add_argument("--child-timeout", type=float, default=1500.0)
    ap.add_argument("--min-n", type=int, default=None,
                    help="bisect floor (default --n // 16)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("bench_job"),
                    help="record file (default %(default)s)")
    # --single: internal re-exec mode (one measurement, in-process).
    ap.add_argument("--single", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--hmpb", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.single:
        if args.cascade_backend == "both":
            ap.error("--single takes one backend")
        if not args.hmpb:
            ap.error("--single needs --hmpb")
        return run_single(args)

    backends = (("scatter", "partitioned")
                if args.cascade_backend == "both"
                else (args.cascade_backend,))
    min_n = args.min_n if args.min_n is not None else max(args.n // 16, 1)
    stderr_log = os.path.join(os.path.dirname(args.out) or ".",
                              "bj_stderr.log")

    tmpdir = tempfile.mkdtemp(prefix="benchjob-")
    landed = {be: False for be in backends}
    results = []
    try:
        n = args.n
        hmpb = None
        while n >= min_n:
            if hmpb is None:
                hmpb = os.path.join(tmpdir, f"points-{n}.hmpb")
                t0 = time.perf_counter()
                synth_hmpb(hmpb, n)
                print(json.dumps({
                    "stage": "synth+write_hmpb",
                    "s": round(time.perf_counter() - t0, 2),
                    "path": hmpb, "n": n,
                    "bytes": os.path.getsize(hmpb)}), flush=True)
            for run in range(args.runs):
                for be in backends:
                    if landed[be] and n != args.n:
                        # Bisected sizes chase only the backends that
                        # never landed.
                        continue
                    rec = _drive_one(args, hmpb, n, run, be, stderr_log)
                    if rec is None:
                        continue
                    landed[be] = True
                    results.append(rec)
            if all(landed.values()):
                break
            # Bisect: halve n and retry the backends that never landed.
            n //= 2
            hmpb = None
            if n >= min_n:
                print(json.dumps({"bisect": True, "next_n": n,
                                  "pending": [b for b, ok in landed.items()
                                              if not ok]}), flush=True)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    write_record(args.out, {"bench": "job", "n": args.n,
                            "results": results})
    if not all(landed.values()):
        print(json.dumps({"error": "no measurement landed",
                          "pending": [b for b, ok in landed.items()
                                      if not ok],
                          "min_n": min_n}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
