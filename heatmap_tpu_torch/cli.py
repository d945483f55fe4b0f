"""Command line of the port: ``python -m heatmap_tpu_torch run ...``.

The ``run`` command is the single-shot batch job (reference batchMain):
points from ``--input`` to heatmap blobs in ``--output``, on the CUDA
card unless ``--device cpu`` asks for the plain PyTorch versions. Its
flags keep the names of ``heatmap_tpu``'s ``run`` command.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from heatmap_tpu_torch.pipeline.timespan import VALID_TYPES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="heatmap-tpu-torch",
        description="heatmap aggregation on PyTorch/CUDA (reference "
        "parity: timfpark/heatmap batch job)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="batch job: points -> heatmap blobs")
    p.add_argument("--input", required=True,
                   help="synthetic:N[:seed] | csv:PATH | jsonl:PATH")
    p.add_argument("--output", default="jsonl:heatmaps.jsonl",
                   help="memory: | jsonl:PATH")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the job runs (default: the CUDA card; "
                   "cpu runs the plain PyTorch versions of the kernels)")
    p.add_argument("--detail-zoom", type=int, default=21,
                   help="finest zoom of the cascade")
    p.add_argument("--min-detail-zoom", type=int, default=5,
                   help="levels run down to min-detail-zoom + 1")
    p.add_argument("--result-delta", type=int, default=5,
                   help="blob tiles are this many zooms coarser")
    p.add_argument("--timespans", default="alltime",
                   help="comma list of alltime,year,month,day")
    p.add_argument("--batch-size", type=int, default=1 << 20)
    p.add_argument("--capacity", type=int, default=None,
                   help="max distinct keys per cascade level "
                   "(default: #emissions)")
    p.add_argument("--amplify-all", action="store_true",
                   help="reproduce the reference's 'all' amplification")
    p.add_argument("--first-timespan-only", action="store_true",
                   help="reproduce the reference's early-return quirk")
    p.add_argument("--cascade-backend", default="auto",
                   choices=("auto", "scatter", "partitioned"),
                   help="cascade reduction: auto (partitioned CUDA "
                   "segment reduce for count jobs on the card, scatter "
                   "otherwise), scatter, or partitioned")
    p.add_argument("--weighted", action="store_true",
                   help="sum the input's per-point 'value' column "
                   "instead of counting points")
    p.add_argument("--weight-bound", type=int, default=None, metavar="W",
                   help="weighted partitioned contract: every 'value' "
                   "is an integer in [0, W]")
    p.set_defaults(fn=cmd_run)
    return ap


def cmd_run(args) -> int:
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig, run_job

    requested = tuple(t.strip() for t in args.timespans.split(",")
                      if t.strip())
    bad = [t for t in requested if t not in VALID_TYPES]
    if bad:
        raise SystemExit(
            f"--timespans: unknown type(s) {bad}; valid: "
            f"{', '.join(VALID_TYPES)}")
    try:
        config = BatchJobConfig(
            detail_zoom=args.detail_zoom,
            min_detail_zoom=args.min_detail_zoom,
            result_delta=args.result_delta,
            timespans=requested,
            amplify_all=args.amplify_all,
            first_timespan_only=args.first_timespan_only,
            capacity=args.capacity,
            weighted=args.weighted,
            weight_bound=args.weight_bound,
            cascade_backend=args.cascade_backend,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e
    source = open_source(args.input)
    t0 = time.perf_counter()
    with open_sink(args.output) as sink:
        blobs = run_job(source, sink, config, batch_size=args.batch_size,
                        device=args.device)
    print(json.dumps({
        "blobs": len(blobs),
        "seconds": time.perf_counter() - t0,
        "device": args.device,
        "cascade_backend": config.resolved_cascade_backend(args.device),
    }), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
