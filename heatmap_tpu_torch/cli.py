"""Command line of the port: ``python -m heatmap_tpu_torch
run|tiles|convert ...``.

``run`` is the batch job (reference batchMain): points from ``--input``
to heatmap blobs (or per-level arrays) in ``--output``. CSV and HMPB
inputs take the integer fast path on their own (``--no-fast`` opts
out, ``--fast`` makes ineligibility an error); sources too large for
host RAM, or ``--max-points-in-flight N``, run chunked;
``--checkpoint-dir`` resumes an interrupted job. ``tiles`` bins points
into a dense window raster and writes a z/x/y PNG tile tree.
``convert`` writes any source as HMPB. ``run`` and ``tiles`` run on the
CUDA card unless ``--device cpu`` asks for the plain PyTorch versions of
the kernels; every command keeps the flag names of ``heatmap_tpu``'s.
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
                   help="synthetic:N[:seed] | csv:PATH | jsonl:PATH | "
                   "hmpb:PATH")
    p.add_argument("--output", default="jsonl:heatmaps.jsonl",
                   help="memory: | jsonl:PATH | arrays:DIR (columnar "
                   "per-level npz)")
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
    p.add_argument("--max-points-in-flight", type=int, default=None,
                   metavar="N",
                   help="bound peak memory: run the cascade per chunk of "
                   "at most N points and merge per-level aggregates "
                   "(exact). Default: auto (sources estimated larger "
                   "than host RAM run chunked); 0 forces single-shot")
    p.add_argument("--merge-spill-dir", default=None, metavar="DIR",
                   help="chunked path only: spill per-chunk aggregates "
                   "to DIR and merge one level at a time at egress")
    p.add_argument("--fast", action="store_true",
                   help="require the integer fast path (csv or hmpb "
                   "input); eligible inputs take it on their own, so "
                   "this only turns a silent fallback into an error")
    p.add_argument("--no-fast", action="store_true",
                   help="disable the automatic fast path and run the "
                   "generic per-row ingest")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint ingest progress here and resume from "
                   "the latest checkpoint on rerun")
    p.add_argument("--checkpoint-every", type=int, default=8,
                   help="checkpoint every N source batches")
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

    p = sub.add_parser("tiles", help="points -> z/x/y PNG tile tree")
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="tiles")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where binning runs (default: the CUDA card; cpu "
                   "runs the plain PyTorch versions of the kernels)")
    p.add_argument("--no-x64", action="store_true",
                   help="project in float32 (the fast path) instead of "
                   "float64")
    p.add_argument("--zoom", type=int, default=16,
                   help="detail (pixel) zoom")
    p.add_argument("--pixel-delta", type=int, default=8,
                   help="tile zoom = zoom - pixel_delta; 8 -> 256px tiles")
    p.add_argument("--lat-min", type=float, default=45.0)
    p.add_argument("--lat-max", type=float, default=50.0)
    p.add_argument("--lon-min", type=float, default=-125.0)
    p.add_argument("--lon-max", type=float, default=-119.0)
    p.add_argument("--auto-bounds", action="store_true",
                   help="derive the window from the data's bounding box "
                   "(one extra pass over the source) instead of the "
                   "--lat/--lon flags")
    p.add_argument("--batch-size", type=int, default=1 << 20)
    p.add_argument("--splat", type=int, default=0, metavar="K",
                   help="smooth with a KxK Gaussian kernel before "
                   "rendering (e.g. 9; 0 = off)")
    p.add_argument("--sigma", type=float, default=None,
                   help="Gaussian sigma in cells (default K/4)")
    p.add_argument("--weighted", action="store_true",
                   help="sum the input's per-point 'value' column instead "
                   "of counting points")
    p.add_argument("--bin-backend", default="auto",
                   choices=("auto", "xla", "pallas", "partitioned"),
                   help="binning path: auto (on the card, the histogram "
                   "kernel for windows up to 256x256 cells and the "
                   "partitioned kernel above; the plain scatter on the "
                   "CPU), xla (the plain scatter), pallas (the histogram "
                   "kernel) or partitioned")
    p.set_defaults(fn=cmd_tiles)

    p = sub.add_parser("convert", help="convert a source to the HMPB "
                       "binary columnar point format (mmap ingest)")
    p.add_argument("--input", required=True, help="any source spec")
    p.add_argument("--output", required=True,
                   help="output .hmpb path (a directory of part files "
                   "with --shard-rows)")
    p.add_argument("--batch-size", type=int, default=1 << 20)
    p.add_argument("--shard-rows", type=int, default=None,
                   help="split the output into part-NNNNN.hmpb files of "
                   "at most this many rows")
    p.set_defaults(fn=cmd_convert)
    return ap


def cmd_run(args) -> int:
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline.batch import (
        BatchJobConfig,
        run_job,
        run_job_fast,
        run_job_resumable,
    )

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
    if args.merge_spill_dir and args.checkpoint_dir:
        raise SystemExit("--merge-spill-dir applies to the bounded "
                         "(chunked) path only; it cannot combine with "
                         "--checkpoint-dir")
    # 0 means "explicitly single-shot", which composes with checkpoints.
    if args.max_points_in_flight and args.checkpoint_dir:
        raise SystemExit("--max-points-in-flight and --checkpoint-dir are "
                         "mutually exclusive (chunk boundaries are not "
                         "batch boundaries)")
    if args.fast and args.no_fast:
        raise SystemExit("--fast and --no-fast are mutually exclusive")
    fast_source = _fast_source(args)
    t0 = time.perf_counter()
    with open_sink(args.output) as sink:
        if fast_source is not None:
            blobs = run_job_fast(
                fast_source, sink, config, batch_size=args.batch_size,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                max_points_in_flight=args.max_points_in_flight,
                merge_spill_dir=args.merge_spill_dir, device=args.device)
        elif args.checkpoint_dir:
            blobs = run_job_resumable(
                open_source(args.input, read_value=args.weighted),
                args.checkpoint_dir, sink, config,
                batch_size=args.batch_size,
                checkpoint_every=args.checkpoint_every, device=args.device)
        else:
            blobs = run_job(
                open_source(args.input, read_value=args.weighted), sink,
                config, batch_size=args.batch_size,
                max_points_in_flight=args.max_points_in_flight,
                merge_spill_dir=args.merge_spill_dir, device=args.device)
    summary = {
        "seconds": time.perf_counter() - t0,
        "ingest": "fast" if fast_source is not None else "standard",
        "device": args.device,
        "cascade_backend": config.resolved_cascade_backend(args.device),
    }
    if blobs.get("egress") == "levels":
        summary["levels"] = blobs["levels"]
        summary["rows"] = blobs["rows"]
    else:
        summary["blobs"] = len(blobs)
    print(json.dumps(summary), file=sys.stderr)
    return 0


def _fast_source(args):
    """The fast-path source of a ``run``, or None for the generic path.

    ``--fast`` demands a CSV or HMPB input. Otherwise CSV inputs of count
    jobs (the native decoder reads no weights) and HMPB inputs (weighted
    ones only with a value section) route to the fast path on their own,
    unless ``--no-fast`` or ``--checkpoint-dir`` is given (a checkpoint
    keeps the path that wrote it). Its blobs equal the generic path's.
    """
    from heatmap_tpu_torch import native
    from heatmap_tpu_torch.io import CSVSource, open_source
    from heatmap_tpu_torch.io.hmpb import HMPBDirSource, HMPBSource

    if args.fast:
        src = open_source(args.input, read_value=False)
        if isinstance(src, CSVSource):
            return src.path
        if isinstance(src, (HMPBSource, HMPBDirSource)):
            return src
        raise SystemExit(f"--fast needs a csv or hmpb source, got "
                         f"{args.input!r}")
    if args.no_fast or args.checkpoint_dir:
        return None
    # Sniff the spec before opening anything: opening an .hmpb maps it.
    kind = args.input.partition(":")[0]
    if (kind == "csv" or args.input.endswith(".csv")) and not args.weighted:
        if native.available():
            src = open_source(args.input, read_value=False)
            if isinstance(src, CSVSource):
                return src.path
    elif kind == "hmpb" or args.input.endswith(".hmpb"):
        src = open_source(args.input, read_value=False)
        if not args.weighted or getattr(src, "has_value", False):
            return src
        src.close()
    return None


def cmd_convert(args) -> int:
    from heatmap_tpu_torch.io.hmpb import convert_to_hmpb

    print(json.dumps(convert_to_hmpb(args.input, args.output,
                                     batch_size=args.batch_size,
                                     shard_rows=args.shard_rows)))
    return 0


def _scan_bounds(source, batch_size):
    """Data bounding box, padded 5%, or None for no finite coordinates.

    One pre-pass over the raw lat/lon columns (sources iterate
    deterministically, so re-reading is safe); NaN and infinite
    coordinates are skipped, and window_from_bounds clamps to the
    Mercator-valid band itself.
    """
    import numpy as np

    lat_lo = lon_lo = float("inf")
    lat_hi = lon_hi = float("-inf")
    for batch in source.batches(batch_size):
        lat = np.asarray(batch["latitude"], np.float64)
        lon = np.asarray(batch["longitude"], np.float64)
        if len(lat) == 0:
            continue
        finite = np.isfinite(lat) & np.isfinite(lon)
        if not finite.any():
            continue
        flat, flon = lat[finite], lon[finite]
        lat_lo = min(lat_lo, float(flat.min()))
        lat_hi = max(lat_hi, float(flat.max()))
        lon_lo = min(lon_lo, float(flon.min()))
        lon_hi = max(lon_hi, float(flon.max()))
    if lat_lo > lat_hi:
        return None
    pad_lat = max(0.05 * (lat_hi - lat_lo), 1e-3)
    pad_lon = max(0.05 * (lon_hi - lon_lo), 1e-3)
    return (lat_lo - pad_lat, lat_hi + pad_lat,
            lon_lo - pad_lon, lon_hi + pad_lon)


def tiles_window(args):
    """The window that ``tiles`` bins into: ``args``'s bounds at
    ``--zoom``, aligned and padded to whole tiles of ``--pixel-delta``."""
    from heatmap_tpu_torch.ops.histogram import window_from_bounds

    return window_from_bounds(
        (args.lat_min, args.lat_max),
        (args.lon_min, args.lon_max),
        zoom=args.zoom,
        align_levels=min(args.pixel_delta, args.zoom),
        pad_multiple=1 << args.pixel_delta,
    )


def run_tiles(args, source=None):
    """The ``tiles`` command: bin ``args.input`` into the window raster on
    ``args.device``, optionally splat it, and write the PNG tile tree.
    Returns ``(summary, raster)``: the summary that ``tiles`` prints,
    with the resolved backend and the milliseconds of each stage, and
    the raster the tiles were rendered from, on ``args.device`` (None
    when no point was read). ``source``, an opened io Source, replaces
    ``args.input`` for callers that build their own."""
    if args.zoom < args.pixel_delta:
        raise SystemExit(
            f"--zoom {args.zoom} must be >= --pixel-delta {args.pixel_delta} "
            "(tile zoom = zoom - pixel_delta)"
        )
    if args.splat and (args.splat < 0 or args.splat % 2 == 0):
        raise SystemExit(f"--splat {args.splat}: kernel size must be odd")
    if args.sigma is not None and not args.sigma > 0:
        raise SystemExit(f"--sigma {args.sigma}: must be positive")
    import torch

    from heatmap_tpu_torch.devices import StageTimer, resolve_device
    from heatmap_tpu_torch.io import PNGTileSink, open_source
    from heatmap_tpu_torch.ops.histogram import _pick_backend, bin_rowcol_window
    from heatmap_tpu_torch.pipeline.batch import load_columns
    from heatmap_tpu_torch.tilemath.mercator import project_points

    device = resolve_device(args.device)
    proj_dtype = torch.float32 if args.no_x64 else torch.float64
    if source is None:
        # Count-only runs skip the value column; --weighted reads it.
        source = open_source(args.input, read_value=bool(args.weighted))
    if args.auto_bounds:
        bounds = _scan_bounds(source, args.batch_size)
        if bounds is None:
            return {"tiles": 0, "output": args.output}, None
        args.lat_min, args.lat_max, args.lon_min, args.lon_max = bounds
    window = tiles_window(args)
    timer = StageTimer(device)
    raster = None
    t0 = time.perf_counter()
    batches = iter(source.batches(args.batch_size))
    while True:
        with timer.stage("ingest"):
            batch = next(batches, None)
            if batch is not None:
                cols = load_columns(batch)
                if args.weighted and "value" not in cols:
                    raise SystemExit(
                        "--weighted needs a 'value' column in the input "
                        "(CSV/JSONL/Parquet column named 'value')"
                    )
                lat = torch.as_tensor(cols["latitude"], device=device)
                lon = torch.as_tensor(cols["longitude"], device=device)
                weights = (torch.as_tensor(cols["value"], device=device).to(
                    torch.float32) if args.weighted else None)
        if batch is None:
            break
        with timer.stage("project"):
            row, col, valid = project_points(lat, lon, window.zoom,
                                             dtype=proj_dtype)
        with timer.stage("bin"):
            part = bin_rowcol_window(row, col, window, weights=weights,
                                     valid=valid, backend=args.bin_backend)
            raster = part if raster is None else raster + part
    if raster is None:
        return {"tiles": 0, "output": args.output}, None
    if args.splat:
        from heatmap_tpu_torch.ops.splat import gaussian_kernel_1d, splat_raster

        with timer.stage("splat"):
            raster = splat_raster(
                raster, gaussian_kernel_1d(args.splat, args.sigma))
    with timer.stage("egress"):
        sink = PNGTileSink(args.output, pixel_delta=args.pixel_delta)
        n = sink.write_window(raster.cpu().numpy(), window)
    summary = {
        "tiles": n,
        "tile_zoom": args.zoom - args.pixel_delta,
        "bounds": [round(args.lat_min, 6), round(args.lat_max, 6),
                   round(args.lon_min, 6), round(args.lon_max, 6)],
        "seconds": round(time.perf_counter() - t0, 3),
        "output": args.output,
        "device": str(device),
        "window": [window.height, window.width],
        "bin_backend": _pick_backend(args.bin_backend, window, device),
        "stage_ms": {k: sum(v) for k, v in timer.ms.items()},
    }
    return summary, raster


def cmd_tiles(args) -> int:
    print(json.dumps(run_tiles(args)[0]))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
