"""Command line of the port: ``python -m heatmap_tpu_torch
run|tiles|stream|serve|render|convert|merge|info|update|retract|ingest|
writeplane ...``, the JAX CLI's twelve commands.

``run`` is the batch job (reference batchMain): points from ``--input``
to heatmap blobs (or per-level arrays) in ``--output``; the reference's
own ends, ``cassandra:``/``cosmosdb:`` in and ``cassandra:`` out, need
an injected client session, so from the command line they fail with
the JAX run's ``ConfigError``/``SinkConfigError`` (exit 1). CSV and HMPB
inputs take the integer fast path on their own (``--no-fast`` opts
out, ``--fast`` makes ineligibility an error); sources too large for
host RAM, or ``--max-points-in-flight N``, run chunked;
``--checkpoint-dir`` resumes an interrupted job. ``tiles`` bins points
into a dense window raster and writes a z/x/y PNG tile tree. ``stream``
consumes a source as timed micro-batches into a decayed live raster and
writes its final snapshot as tiles. ``convert`` writes any source as
HMPB, ``merge`` merges egress shards, ``info`` prints the resolved
backend and devices. ``update`` applies journaled delta batches (and
signed retractions) to a delta store and compacts it; ``retract``
removes every journaled row matching a predicate (heatmap_tpu_torch.
delta); ``ingest`` drains a source as micro-batches through the
continuous-ingest loop, each journaled and applied as its own delta
(heatmap_tpu_torch.ingest), publishing to an in-process tile server
with ``--serve-port``. ``writeplane`` drains sources through N pump
threads into per-Morton-range delta stores under one epoch-flipped
manifest (heatmap_tpu_torch.writeplane). ``serve`` answers tile, query
and health requests over a stored artifact (heatmap_tpu_torch.serve),
with a live stream layer under ``--follow-stream``, or from N child
processes behind a router under ``--fleet N``; ``render`` draws a
stored slice as a PNG tile tree. Stores are interchangeable with the
JAX package's.

``run``, ``update``, ``ingest`` and ``writeplane`` carry the telemetry
envelope:
``--metrics-dir``, ``--events``, ``--report``, ``--trace-out``,
``--trace-sample``, ``--slo``, ``--flight-recorder-spans``,
``--incident-dir``, ``--tail-latency-ms``,
``--telemetry-sample-interval`` and ``--watch`` (``run`` also
``--profile``); with all of them off the commands write the same
bytes. The mesh flags (``--data-parallel``, ``--dispatch``; on ``run``
also ``--dp-merge``, ``--spatial-partition`` and the multihost and
elastic flags) drive ``heatmap_tpu_torch.parallel``.

Every command keeps the flag names of ``heatmap_tpu``'s. ``serve``
(without ``--follow-stream``, and every fleet backend) and ``render``
do no device work, as in the JAX package. The device commands (``run``,
``tiles``, ``stream``, ``update``, ``retract``, ``ingest``,
``writeplane`` and ``serve --follow-stream``) run on the CUDA card unless
``--backend cpu`` (or its alias ``--device cpu``) asks for the plain
PyTorch versions of the kernels; ``--chaos``/``$HEATMAP_TPU_CHAOS`` arm
the fault plane (heatmap_tpu_torch.faults).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from heatmap_tpu_torch.pipeline.timespan import VALID_TYPES


def _add_backend_flags(p):
    p.add_argument(
        "--backend", choices=("tpu", "cpu"), default=None,
        help="device platform, as heatmap_tpu names it: tpu = the CUDA "
        "card (default), cpu = the plain PyTorch versions on the host")
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="alias of --backend (cuda = tpu); giving both with "
        "different values is an error")
    p.add_argument(
        "--device-timeout", type=float, default=180.0,
        help="seconds to wait for the CUDA card to initialise before "
        "failing the command (0 disables the probe)")
    p.add_argument(
        "--no-x64", action="store_true",
        help="project in float32 instead of float64 (tiles, stream); "
        "the batch job's composite keys need 64 bits and refuse it")
    p.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="arm deterministic fault injection (heatmap_tpu_torch."
        "faults), e.g. 'seed=7,scale=0,sink.write=1'; also read from "
        "$HEATMAP_TPU_CHAOS (flag wins)")


def _device(args) -> str:
    """"cuda" or "cpu" from ``--backend`` and its alias ``--device``;
    both given and disagreeing is an error. Sets both on ``args``."""
    from_backend = {"tpu": "cuda", "cpu": "cpu", None: None}[args.backend]
    if (args.device is not None and from_backend is not None
            and args.device != from_backend):
        raise SystemExit(
            f"--device {args.device} disagrees with --backend "
            f"{args.backend} (--backend tpu is --device cuda)")
    args.device = args.device or from_backend or "cuda"
    args.backend = "cpu" if args.device == "cpu" else "tpu"
    return args.device


def _init_backend(args) -> str:
    """Arm the fault plane, resolve the device, and on the card probe
    CUDA initialisation on a daemon thread bounded by
    ``--device-timeout``, so an unanswering device fails the command
    instead of hanging it. Returns the device. No fallback: a command
    pinned to the card never quietly runs on the CPU."""
    from heatmap_tpu_torch import faults

    faults.install_from_env(getattr(args, "chaos", None))
    device = _device(args)
    if device == "cpu" or not args.device_timeout > 0:
        return device
    import threading

    import torch

    from heatmap_tpu_torch.devices import resolve_device

    done = threading.Event()
    error: list = []

    def _probe():
        try:
            resolve_device(device)
            torch.cuda.init()
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            error.append(e)
        done.set()

    threading.Thread(target=_probe, daemon=True).start()
    if not done.wait(timeout=args.device_timeout):
        raise SystemExit(
            f"the CUDA device did not initialise within "
            f"{args.device_timeout:.0f}s — retry later, raise "
            "--device-timeout, or run with --backend cpu")
    if error:
        raise error[0]
    return device


def _sink_spec(spec: str) -> str:
    """argparse type= wrapper: reject a typo'd --output kind at parse
    time with a one-line error."""
    from heatmap_tpu_torch.io.sinks import validate_sink_spec

    try:
        return validate_sink_spec(spec)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from e


def _add_telemetry_flags(p):
    p.add_argument("--metrics-dir", default=None, metavar="DIR",
                   help="enable the metrics registry and write a "
                   "Prometheus-text dump to DIR/metrics.prom at command "
                   "end (docs/observability.md)")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="append structured run events to PATH (JSONL: "
                   "run_start, stage_end, delta_applied, compaction_*, "
                   "run_end; the JAX package's schema)")
    p.add_argument("--report", nargs="?", const="run_report.json",
                   default=None, metavar="PATH",
                   help="fold tracer + metrics + events into a run report "
                   "at PATH (default run_report.json) and print the span "
                   "table to stderr")


def _add_trace_flags(p):
    """--trace-out / --trace-sample and the rest of the telemetry
    envelope (SLOs, flight recorder, incidents, sampler, watches),
    shared by run, update and ingest (docs/observability.md)."""
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="enable hierarchical span tracing and export the "
                   "span trees as Chrome/Perfetto trace-event JSON to "
                   "PATH at exit")
    p.add_argument("--trace-sample", type=float, default=1.0, metavar="P",
                   help="probability a new trace root is sampled "
                   "(default 1.0 records every trace)")
    p.add_argument("--slo", action="append", default=None, metavar="SPEC",
                   help="declare an SLO as NAME:KIND:k=v,... (kinds: "
                   "latency, error_rate, staleness; repeatable). "
                   "Error-budget burn rates fold into the run report "
                   "and slo_breach events")
    p.add_argument("--flight-recorder-spans", type=int, default=256,
                   metavar="N",
                   help="flight-recorder ring capacity: last N completed "
                   "spans per subsystem kept regardless of head "
                   "sampling, promoted into the trace on errors and tail "
                   "latency (0 disables the recorder; it only arms when "
                   "--trace-out, --events or --incident-dir is also "
                   "given)")
    p.add_argument("--incident-dir", default=None, metavar="DIR",
                   help="flush self-contained incident bundles here on "
                   "failure edges (SLO breach, fault storm, anomaly, "
                   "uncaught exception); rate-limited and pruned "
                   "age-wins")
    p.add_argument("--tail-latency-ms", type=float, default=None,
                   metavar="MS",
                   help="tail-based retention threshold: any trace "
                   "slower than this is promoted from the flight "
                   "recorder into the trace as if head-sampled")
    p.add_argument("--telemetry-sample-interval", type=float, default=0.0,
                   metavar="SEC",
                   help="background telemetry sampler cadence: every SEC "
                   "seconds the obs registry is snapshotted into the "
                   "in-process time-series tiers that back incident "
                   "bundles (spilled under --incident-dir/telemetry). 0 "
                   "(the default) disables the sampler: zero threads, "
                   "zero hot-path cost")
    p.add_argument("--watch", action="append", default=None, metavar="SPEC",
                   help="watch a telemetry series for anomalies as "
                   "NAME:k=v,... (params: z, alpha, min_count, "
                   "clear_ratio; repeatable), e.g. "
                   "'ingest_lag_seconds:z=6'. Each rising edge emits one "
                   "anomaly_detected event and triggers an incident "
                   "bundle; requires --telemetry-sample-interval > 0")


def _setup_tracing(args):
    """Wire --trace-out/--trace-sample/--slo and the flight recorder,
    incident manager, sampler and watches, as the JAX CLI does; returns
    the live TraceCollector (None with tracing off). With every flag
    off nothing is installed, so every obs hook stays None."""
    from heatmap_tpu_torch import obs

    collector = None
    if getattr(args, "trace_out", None):
        try:
            collector = obs.enable_tracing(sample=args.trace_sample)
        except ValueError as e:
            raise SystemExit(f"--trace-sample: {e}") from e
    if getattr(args, "slo", None):
        try:
            obs.install_specs(args.slo)
        except ValueError as e:
            raise SystemExit(f"--slo: {e}") from e
    # The recorder arms only when some telemetry surface exists to
    # promote or flush into.
    spans = getattr(args, "flight_recorder_spans", 0) or 0
    if spans < 0:
        raise SystemExit(f"--flight-recorder-spans {spans}: must be >= 0")
    incident_dir = getattr(args, "incident_dir", None)
    armed = (collector is not None or incident_dir
             or getattr(args, "events", None))
    if spans and armed:
        tail_ms = getattr(args, "tail_latency_ms", None)
        if tail_ms is not None and tail_ms <= 0:
            raise SystemExit(
                f"--tail-latency-ms {tail_ms}: must be positive")
        obs.recorder.install(obs.FlightRecorder(
            max_spans=spans,
            tail_latency_s=None if tail_ms is None else tail_ms / 1000.0))
    if incident_dir:
        obs.incident.set_manager(obs.IncidentManager(incident_dir))
    # Interval 0 (the default) arms nothing: no store, no thread.
    interval = getattr(args, "telemetry_sample_interval", 0.0) or 0.0
    if interval < 0:
        raise SystemExit(f"--telemetry-sample-interval {interval}: "
                         "must be >= 0")
    watches = getattr(args, "watch", None) or []
    if watches and not interval:
        raise SystemExit("--watch requires --telemetry-sample-interval "
                         "> 0 (detectors score sampler ticks)")
    if interval:
        engine = None
        if watches:
            try:
                specs = [obs.parse_watch_spec(s) for s in watches]
            except ValueError as e:
                raise SystemExit(f"--watch: {e}") from e
            engine = obs.AnomalyEngine(specs)
            obs.anomaly.set_engine(engine)
        spill_dir = (os.path.join(incident_dir, "telemetry")
                     if incident_dir else None)
        obs.timeseries.arm(interval, engine=engine, spill_dir=spill_dir)
    return collector


def _fail_telemetry(root_span, error):
    """Uncaught job exception: tail-promote the failed root's tree out of
    the flight recorder and flush an exception incident bundle. Both
    no-op when nothing is installed. Runs before end_span on the root so
    the root rides the live-forward path."""
    from heatmap_tpu_torch.obs import incident, recorder

    recorder.maybe_promote(root_span, error=True)
    incident.trigger("exception", detail=repr(error))


#: ``--data-parallel`` value -> BatchJobConfig.data_parallel.
_DATA_PARALLEL = {"auto": None, "on": True, "off": False}


def _add_parallel_flags(p):
    """The JAX mesh flags: the cascade's data-parallel route over the
    process's local devices (parallel/)."""
    p.add_argument("--data-parallel", choices=("auto", "on", "off"),
                   default="auto",
                   help="data-parallelize the cascade over the local "
                   "devices: auto (past one device and the auto-DP "
                   "threshold), on (any size; one card gives a 1-shard "
                   "mesh) or off")
    p.add_argument("--dispatch", choices=("auto", "gspmd", "shard_map"),
                   default="auto",
                   help="data-parallel cascade formulation: gspmd "
                   "(on-device routing, global-view rollup), shard_map "
                   "(host-routed shard bodies) or auto (gspmd except "
                   "with --dp-merge prefix). Blobs byte-identical")


def _add_run_parallel_flags(p):
    """The rest of the JAX ``run``'s mesh and multihost flags, with its
    choices and defaults."""
    p.add_argument("--dp-merge", choices=("replicated", "prefix"),
                   default="replicated",
                   help="data-parallel cascade merge: replicated "
                   "(all-gather the partials) or prefix (regroup by key "
                   "range); blobs identical")
    p.add_argument("--dp-min-emissions", type=int, default=None,
                   metavar="N",
                   help="auto-DP engagement threshold (emissions); "
                   "auto mode only")
    p.add_argument("--spatial-partition", choices=("auto", "morton", "off"),
                   default="auto",
                   help="Morton-range sharding of the data-parallel "
                   "cascade: auto (at the auto-DP threshold), morton "
                   "(whenever the mesh engages) or off; blobs identical")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host job: each process (one per host, the "
                   "cluster from $JAX_COORDINATOR_ADDRESS, "
                   "$JAX_NUM_PROCESSES, $JAX_PROCESS_ID over gloo) "
                   "ingests its slice; a single process runs the plain "
                   "job")
    p.add_argument("--multihost-egress",
                   choices=("auto", "gather", "sharded"), default="auto",
                   help="gather (the auto default) or sharded (this "
                   "process writes its own sink shard: a .p000 file, "
                   "or host000/ directory)")
    p.add_argument("--heartbeat-deadline", type=float, default=None,
                   metavar="S",
                   help="arm straggler detection: a host whose heartbeat "
                   "is older than S seconds at a phase boundary is a "
                   "StragglerTimeout")
    p.add_argument("--on-straggler", choices=("raise", "reassign"),
                   default="raise",
                   help="raise (default) or reassign (elastic "
                   "execution: the stale host's shards re-run on "
                   "survivors from the --elastic-dir lineage manifest, "
                   "output byte-identical)")
    p.add_argument("--elastic-dir", default=None, metavar="DIR",
                   help="shard-lineage manifest root for --on-straggler "
                   "reassign")
    p.add_argument("--elastic-hosts", type=int, default=None, metavar="K",
                   help="simulated host count for elastic execution")


def _check_run_parallel_flags(args):
    """The JAX ``run``'s refusals of its multihost flags, with its
    messages (exit 1 through SystemExit)."""
    if args.multihost_egress != "auto" and not args.multihost:
        raise SystemExit("--multihost-egress requires --multihost")
    if not args.multihost and (args.on_straggler != "raise"
                               or args.elastic_dir or args.elastic_hosts
                               or args.heartbeat_deadline is not None):
        raise SystemExit("--heartbeat-deadline / --on-straggler / "
                         "--elastic-dir / --elastic-hosts require "
                         "--multihost")
    if args.on_straggler == "reassign" and not args.elastic_dir:
        raise SystemExit("--on-straggler reassign needs --elastic-dir "
                         "(the shard-lineage manifest is what makes "
                         "failover re-execution exactly-once)")
    if args.multihost and (args.fast or args.checkpoint_dir):
        raise SystemExit("--multihost runs the standard job path only "
                         "(not --fast / --checkpoint-dir); "
                         "--max-points-in-flight composes (each process "
                         "streams its slice through the bounded path)")


class _Telemetry:
    """The telemetry envelope of ``run``, ``update`` and ``ingest``, as
    the JAX CLI wires it: ``--metrics-dir``/``--events``/``--report``
    enable the registry (reset for this command) and the event log
    (``run_start`` here, ``run_end`` in :meth:`finish`); the trace flags
    go through :func:`_setup_tracing`; ``providers`` (name -> callable)
    register incident state providers; the command's root span opens
    here. With every flag off nothing is installed. :meth:`finish`
    leaves obs as it found it, so a later command in the same process
    starts clean."""

    def __init__(self, args, root: str, config=None, device="cpu",
                 providers=None):
        from heatmap_tpu_torch import obs
        from heatmap_tpu_torch.obs import tracing

        self.args = args
        self.on = bool(args.metrics_dir or args.events
                       or args.report is not None)
        self.log = None
        if self.on:
            obs.get_registry().reset()
            obs.enable_metrics(True)
            if args.events:
                self.log = obs.EventLog(args.events)
                obs.set_event_log(self.log)
                manifest = ({} if config is None else
                            {k: (list(v) if isinstance(v, tuple) else v)
                             for k, v in dataclasses.asdict(config).items()})
                obs.emit("run_start", config=manifest, backend=args.backend,
                         devices=obs.device_topology(device),
                         argv=sys.argv[1:])
        self.collector = None
        try:
            self.collector = _setup_tracing(args)
        except SystemExit:
            # A bad telemetry flag: leave obs as it was found.
            if self.log is not None:
                obs.set_event_log(None)
                self.log.close()
            obs.enable_metrics(False)
            obs.disable_tracing()
            self._teardown()
            raise
        for name, fn in (providers or {}).items():
            obs.incident.add_state_provider(name, fn)
        self.root = tracing.begin_span(root)
        self.t0 = time.perf_counter()

    def finish(self, error=None, sample_memory=False, **end) -> float:
        """Close the root span and write ``run_end`` (``end`` on
        success, the error otherwise), metrics.prom, the report and the
        trace. Returns the command's seconds."""
        from heatmap_tpu_torch import obs
        from heatmap_tpu_torch.obs import tracing
        from heatmap_tpu_torch.utils.trace import get_tracer

        dt = time.perf_counter() - self.t0
        if error is not None:
            _fail_telemetry(self.root, error)
        tracing.end_span(self.root)
        args = self.args
        if self.on:
            if sample_memory:
                obs.sample_device_memory()
            if self.log is not None:
                rec = {"status": "error" if error is not None else "ok",
                       "seconds": round(dt, 3)}
                if error is not None:
                    rec["error"] = repr(error)
                else:
                    rec.update(end)
                obs.emit("run_end", **rec)
                obs.set_event_log(None)
                self.log.close()
            if args.metrics_dir:
                obs.get_registry().write_prometheus(
                    os.path.join(args.metrics_dir, "metrics.prom"))
            if args.report is not None:
                report = obs.build_run_report(
                    tracer=get_tracer(), registry=obs.get_registry(),
                    events_path=args.events)
                obs.write_run_report(args.report, report)
                print(obs.format_run_report(report), file=sys.stderr)
            obs.enable_metrics(False)
        # The sampler stops (with a final spill) before the trace export.
        obs.timeseries.shutdown()
        if self.collector is not None:
            n = self.collector.export_chrome(args.trace_out)
            print(json.dumps({"trace_out": args.trace_out,
                              "span_events": n,
                              "dropped": self.collector.dropped}),
                  file=sys.stderr)
        self._teardown()
        return dt

    def _teardown(self):
        """Uninstall what :func:`_setup_tracing` installed."""
        from heatmap_tpu_torch import obs

        obs.timeseries.shutdown()
        obs.anomaly.set_engine(None)
        obs.incident.set_manager(None)
        obs.recorder.install(None)
        obs.slo.set_engine(None)
        if self.collector is not None:
            obs.disable_tracing()


BIN_BACKEND_HELP = (
    "binning path: auto (on the card, the histogram kernel for windows up "
    "to 256x256 cells and the partitioned kernel above; the plain scatter "
    "on the CPU), xla (the plain scatter), pallas (the histogram kernel) "
    "or partitioned")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="heatmap-tpu-torch",
        description="heatmap aggregation on PyTorch/CUDA (reference "
        "parity: timfpark/heatmap batch job)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="batch job: points -> heatmap blobs")
    _add_backend_flags(p)
    p.add_argument("--input", required=True,
                   help="synthetic:N[:seed] | csv:PATH | jsonl:PATH | "
                   "parquet:PATH | hmpb:PATH | cassandra:[ENDPOINT] | "
                   "cosmosdb:")
    p.add_argument("--output", default="jsonl:heatmaps.jsonl",
                   type=_sink_spec,
                   help="memory: | jsonl:PATH | dir:PATH | cassandra: | "
                   "arrays:DIR (columnar per-level npz) | "
                   "arrays-parquet:DIR | arrays-synopsis:DIR | "
                   "arrays-integral:DIR | arrays-tilefs:DIR")
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
    _add_parallel_flags(p)
    _add_run_parallel_flags(p)
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace into "
                   "LOGDIR/trace.json and print the span/throughput "
                   "report to stderr")
    _add_telemetry_flags(p)
    _add_trace_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("tiles", help="points -> z/x/y PNG tile tree")
    _add_backend_flags(p)
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="tiles")
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
                   help=BIN_BACKEND_HELP)
    p.set_defaults(fn=cmd_tiles)

    p = sub.add_parser("stream", help="micro-batch streaming: decayed live "
                       "raster -> PNG tiles (BASELINE.md config 4)")
    _add_backend_flags(p)
    p.add_argument("--input", required=True,
                   help="source spec, consumed as micro-batches")
    p.add_argument("--output", default=None,
                   help="PNG tile tree dir for the final snapshot ('' = "
                   "none; default: live_tiles/ under --live-dir)")
    p.add_argument("--live-dir", default=None,
                   help="root for runtime tile artifacts (default: "
                   "--checkpoint-dir when given, else the system tmp dir)")
    p.add_argument("--batch-points", type=int, default=1 << 16,
                   help="points per micro-batch (one update step)")
    p.add_argument("--bin-backend", default="auto",
                   choices=("auto", "xla", "pallas", "partitioned"),
                   help=BIN_BACKEND_HELP)
    p.add_argument("--interval", type=float, default=60.0,
                   help="stream seconds advanced per micro-batch")
    p.add_argument("--half-life", type=float, default=3600.0,
                   help="decay half-life in stream seconds")
    p.add_argument("--zoom", type=int, default=12)
    p.add_argument("--pixel-delta", type=int, default=8)
    p.add_argument("--lat-min", type=float, default=45.0)
    p.add_argument("--lat-max", type=float, default=50.0)
    p.add_argument("--lon-min", type=float, default=-125.0)
    p.add_argument("--lon-max", type=float, default=-119.0)
    p.add_argument("--auto-bounds", action="store_true",
                   help="derive the window from the data's bounding box "
                   "(file sources only: one extra pass; resume keeps the "
                   "same window for the same file)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=16)
    p.add_argument("--weighted", action="store_true",
                   help="sum the input's per-point 'value' column into "
                   "the decayed raster instead of counting")
    p.set_defaults(fn=cmd_stream)

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

    p = sub.add_parser(
        "merge",
        help="merge egress shards (per-host jsonl blob files or "
        "level-array dirs) into one artifact; colliding blob ids sum")
    p.add_argument("--inputs", nargs="+", required=True,
                   help="JSONL blob files, or level-array dirs (all one "
                   "kind)")
    p.add_argument("--output", required=True, type=_sink_spec,
                   help="blob sink spec (jsonl:/dir:/memory:) for blob "
                   "inputs; arrays:DIR for level-array inputs")
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("info", help="resolved config + devices")
    _add_backend_flags(p)
    p.add_argument("--probe-timeout", type=float, default=20.0,
                   help="seconds to wait for device discovery before "
                   "reporting the backend unreachable")
    # info never runs the fail-fast probe; an explicit --device-timeout
    # is honored as the probe timeout (None = flag not given).
    p.set_defaults(fn=cmd_info, device_timeout=None)

    p = sub.add_parser(
        "update",
        help="incremental update: journaled delta apply + compaction "
        "against a delta store")
    _add_backend_flags(p)
    _add_update_flags(p)
    p.set_defaults(fn=cmd_update)

    p = sub.add_parser(
        "retract",
        help="predicate retraction against a delta store: journal scan "
        "-> exact signed counter-batches")
    _add_backend_flags(p)
    _add_retract_flags(p)
    p.set_defaults(fn=cmd_retract)

    p = sub.add_parser(
        "ingest",
        help="continuous ingest: source -> bounded queue -> journaled "
        "delta applies (+ compaction) against a delta store")
    _add_backend_flags(p)
    _add_ingest_flags(p)
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser(
        "serve",
        help="tile HTTP server over stored heatmaps: "
        "GET /tiles/{layer}/{z}/{x}/{y}.png|.json (docs/serving.md)")
    _add_backend_flags(p)  # used only by --follow-stream
    _add_serve_flags(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "render",
        help="stored heatmaps (arrays:DIR / jsonl:PATH) -> PNG tile tree")
    p.add_argument("--input", required=True,
                   help="arrays:DIR, arrays-parquet:DIR or jsonl:PATH")
    p.add_argument("--output", default="rendered_tiles")
    p.add_argument("--user", default="all",
                   help="user slice to render (default 'all')")
    p.add_argument("--timespan", default="alltime")
    p.add_argument("--zoom", type=int, default=None,
                   help="stored detail zoom to render "
                   "(default: finest available)")
    p.add_argument("--pixel-delta", type=int, default=8)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser(
        "writeplane",
        help="partitioned multi-writer ingest: Morton-range-sharded "
        "journals + epoch-unified manifest (serve mounts the root as "
        "writeplane:ROOT — docs/write-plane.md)")
    _add_backend_flags(p)
    _add_writeplane_flags(p)
    p.set_defaults(fn=cmd_writeplane)
    return ap


def _add_serve_flags(p):
    """The JAX ``serve``'s flags."""
    p.add_argument("--store", required=True,
                   help="arrays:DIR (incl. multihost host*/ shard dirs) | "
                   "jsonl:PATH | dir:PATH | delta:ROOT | tilefs:ROOT | "
                   "writeplane:ROOT — any stored heatmap artifact")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="listen port (0 = ephemeral; the bound address is "
                   "printed to stderr)")
    p.add_argument("--cache-bytes", type=int, default=256 << 20,
                   help="tile cache budget in bytes (LRU past it; 0 "
                   "disables caching but keeps single-flight render dedup)")
    p.add_argument("--ttl", type=float, default=None,
                   help="tile cache TTL seconds (default: none for static "
                   "stores; live mode defaults to interval/2 to bound "
                   "decay drift)")
    p.add_argument("--layers", default=None,
                   help="comma list of name=user|timespan layer mounts "
                   "(default: every slice in the artifact plus 'default' "
                   "-> all|alltime)")
    p.add_argument("--synopsis-default", action="store_true",
                   help="serve coarse tiles from wavelet synopses by "
                   "default (docs/synopsis.md); per-request "
                   "?synopsis=0/1 always wins")
    p.add_argument("--render-timeout", type=float, default=None,
                   metavar="S",
                   help="per-tile render deadline in seconds; a render "
                   "past it serves the last-good cached bytes (stale-200) "
                   "or a typed 503, never a hung request")
    p.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="run N shared-nothing backend processes behind a "
                   "consistent-hash router on --port (rendezvous ring, "
                   "circuit breakers, hedged reads, admission control; "
                   "docs/serving.md). Incompatible with --follow-stream")
    p.add_argument("--max-inflight", type=int, default=None, metavar="N",
                   help="admission bound: concurrent tile requests per "
                   "process (router: per backend); past it requests shed "
                   "with 503 + Retry-After. Fleet default: 32")
    p.add_argument("--queue-deadline", type=float, default=0.25,
                   metavar="S",
                   help="fleet router: how long a request may wait for a "
                   "backend slot before shedding")
    p.add_argument("--hedge-quantile", type=float, default=0.95,
                   help="fleet router: hedge a request to the next replica "
                   "once it outlives this latency quantile (first answer "
                   "wins)")
    p.add_argument("--probe-interval", type=float, default=1.0,
                   metavar="S",
                   help="fleet router: active health-probe period "
                   "(half-open probes re-admit recovered backends)")
    p.add_argument("--degrade", action="store_true",
                   help="arm the brownout controller: SLO burn (--slo) "
                   "steps a rung ladder that trades tile fidelity for "
                   "availability under overload. Off by default")
    p.add_argument("--degrade-dwell", type=float, default=10.0,
                   metavar="S",
                   help="seconds the burn must stay above the up "
                   "threshold before the ladder steps up one rung")
    p.add_argument("--degrade-hold", type=float, default=30.0, metavar="S",
                   help="seconds the burn must stay below the down "
                   "threshold before the ladder steps back down")
    p.add_argument("--degrade-ladder", default="", metavar="SPEC",
                   help="ladder tuning, comma list of k=v: "
                   "up=BURN,down=BURN,ttl=SCALE,shed=FRAC,max=RUNG "
                   "(default up=1.0,down=0.5,ttl=4,shed=0.5,max=3)")
    p.add_argument("--disk-cache", default=None, metavar="DIR",
                   help="persist rendered tile bytes under DIR as a "
                   "second cache tier below the heap LRU (docs/tilefs.md)")
    p.add_argument("--disk-cache-bytes", type=int, default=1 << 30,
                   metavar="B",
                   help="disk cache size cap (mtime-LRU eviction)")
    p.add_argument("--prewarm-events", action="append", default=None,
                   metavar="PATH",
                   help="replay the Zipf head of these http_request event "
                   "logs into the caches at startup and after /reload; "
                   "repeatable")
    p.add_argument("--prewarm-top-k", type=int, default=64, metavar="K",
                   help="how many of the most popular tile paths the "
                   "prewarm replays (decayed frequency rank)")
    p.add_argument("--prewarm-budget-s", type=float, default=10.0,
                   metavar="S",
                   help="wall-clock budget for one prewarm pass")
    p.add_argument("--prewarm-bytes", type=int, default=64 << 20,
                   metavar="B",
                   help="rendered-byte budget for one prewarm pass")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="append http_request events to PATH (JSONL, the "
                   "JAX package's schema)")
    _add_trace_flags(p)
    p.add_argument("--follow-stream", default=None, metavar="SPEC",
                   help="live mode: consume this source spec as "
                   "micro-batches into a decayed stream layer on the card "
                   "(--backend cpu: on the host; name via --live-layer); "
                   "ticks invalidate only the affected tile keys")
    p.add_argument("--live-layer", default="live",
                   help="layer name the --follow-stream raster is served "
                   "under")
    p.add_argument("--batch-points", type=int, default=1 << 16)
    p.add_argument("--interval", type=float, default=60.0,
                   help="stream seconds advanced per micro-batch")
    p.add_argument("--tick-seconds", type=float, default=1.0,
                   help="wall-clock pause between micro-batch ticks (0 = "
                   "consume as fast as possible)")
    p.add_argument("--half-life", type=float, default=3600.0)
    p.add_argument("--zoom", type=int, default=12,
                   help="live window detail zoom")
    p.add_argument("--lat-min", type=float, default=45.0)
    p.add_argument("--lat-max", type=float, default=50.0)
    p.add_argument("--lon-min", type=float, default=-125.0)
    p.add_argument("--lon-max", type=float, default=-119.0)


def _add_temporal_flags(p):
    g = p.add_argument_group(
        "temporal buckets",
        "pin the epoch-bucketed partial-pyramid config "
        "(docs/temporal.md). Byte-affecting for temporal folds, so it "
        "follows the config-fingerprint discipline: the first writer "
        "sets it, later runs must match. Compactions then fold history "
        "into buckets/ and serve answers ?as_of=/?window=/?decay= "
        "tiles and op=topk_growth queries.")
    g.add_argument("--bucket-width", type=float, default=None,
                   metavar="UNITS",
                   help="tier-0 bucket width in watermark units "
                   "(setting any --bucket-* flag enables the temporal "
                   "plane; default width 3600)")
    g.add_argument("--bucket-fanout", type=int, default=None,
                   help="geometric ladder fanout: tier-j buckets are "
                   "width * fanout**j wide (default 4)")
    g.add_argument("--bucket-keep", type=int, default=None,
                   help="newest intervals kept per tier before history "
                   "coarsens into the next tier (default 8)")
    g.add_argument("--bucket-tiers", type=int, default=None,
                   help="ladder height; the top tier is unbounded "
                   "(default 4)")
    g.add_argument("--bucket-unit-s", type=float, default=None,
                   metavar="S",
                   help="seconds per watermark unit — scales the named "
                   "?window= values (1h/1d/1w); ms timestamps use "
                   "0.001 (default 1)")


def _ensure_temporal(args, root: str):
    """Pin the temporal config when any --bucket-* flag was passed;
    returns the active config (None = temporal plane not enabled)."""
    overrides = {"width": args.bucket_width, "fanout": args.bucket_fanout,
                 "keep": args.bucket_keep, "tiers": args.bucket_tiers,
                 "unit_s": args.bucket_unit_s}
    if all(v is None for v in overrides.values()):
        return None
    from heatmap_tpu_torch.temporal import ensure_config

    os.makedirs(root, exist_ok=True)
    try:
        return ensure_config(root, **overrides)
    except ValueError as e:
        raise SystemExit(str(e)) from e


def _add_update_flags(p):
    p.add_argument("--journal", required=True, metavar="ROOT",
                   help="delta store root (journal/ + base + delta "
                   "artifacts; created on first use; "
                   "docs/incremental.md)")
    p.add_argument("--input", default=None,
                   help="source spec of NEW points to apply as one "
                   "journaled delta batch")
    p.add_argument("--retractions", default=None,
                   help="source spec of points to RETRACT (a signed "
                   "delta batch: their counts are subtracted)")
    p.add_argument("--base", default=None, type=_sink_spec,
                   metavar="arrays:DIR",
                   help="adopt an existing columnar artifact as the "
                   "store's initial base pyramid (copied in; only valid "
                   "once)")
    p.add_argument("--compact-after", type=int, default=None, metavar="N",
                   help="fold the delta stack into a new base when more "
                   "than N live deltas remain after this update (0 = "
                   "compact whenever any delta is live)")
    p.add_argument("--retention", type=int, default=2,
                   help="journal entries kept after compaction as the "
                   "idempotency window")
    p.add_argument("--detail-zoom", type=int, default=21)
    p.add_argument("--min-detail-zoom", type=int, default=5)
    p.add_argument("--result-delta", type=int, default=5)
    p.add_argument("--timespans", default="alltime")
    p.add_argument("--batch-size", type=int, default=1 << 20)
    p.add_argument("--weighted", action="store_true",
                   help="sum the source's per-point 'value' column "
                   "instead of counting points")
    p.add_argument("--cascade-backend", default="auto",
                   choices=("auto", "scatter", "partitioned"))
    _add_parallel_flags(p)
    _add_telemetry_flags(p)
    _add_temporal_flags(p)
    _add_trace_flags(p)


def cmd_update(args) -> int:
    """Incremental update: journaled delta applies + optional compaction
    against a delta store (heatmap_tpu_torch.delta). The applied batches
    run the full cascade on the card (auto routing included) over just
    the new points. Prints the JAX ``update``'s summary keys."""
    from heatmap_tpu_torch import delta as delta_mod
    from heatmap_tpu_torch.io import open_source
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    requested = tuple(t.strip() for t in args.timespans.split(",")
                      if t.strip())
    bad = [t for t in requested if t not in VALID_TYPES]
    if bad:
        raise SystemExit(
            f"--timespans: unknown type(s) {bad}; valid: "
            f"{', '.join(VALID_TYPES)}")
    if not (args.input or args.retractions or args.base
            or args.compact_after is not None):
        raise SystemExit("nothing to do: pass --input and/or "
                         "--retractions, --base, or --compact-after")
    base_dir = None
    if args.base:
        if not args.base.startswith("arrays:"):
            raise SystemExit("--base must be a columnar arrays:DIR "
                             f"artifact, got {args.base!r}")
        base_dir = args.base[len("arrays:"):]
        if not os.path.isdir(base_dir):
            raise SystemExit(f"--base: {base_dir!r} is not a directory")
    config = None
    device = _device(args)
    if args.input or args.retractions:
        if args.no_x64:
            raise SystemExit(
                "--no-x64: the composite-key cascade needs int64 keys; "
                "drop --no-x64")
        device = _init_backend(args)
        try:
            config = BatchJobConfig(
                detail_zoom=args.detail_zoom,
                min_detail_zoom=args.min_detail_zoom,
                result_delta=args.result_delta,
                timespans=requested,
                weighted=args.weighted,
                cascade_backend=args.cascade_backend,
                data_parallel=_DATA_PARALLEL[args.data_parallel],
                dispatch=args.dispatch,
            )
        except ValueError as e:
            raise SystemExit(str(e)) from e
    tel = _Telemetry(args, "update", config, device)
    summary = {"journal": args.journal}
    try:
        if base_dir is not None:
            delta_mod.init_store(args.journal, base_dir)
            summary["base_adopted"] = args.base
        tcfg = _ensure_temporal(args, args.journal)
        if tcfg is not None:
            summary["temporal"] = tcfg
        applied = []
        jobs = [(args.input, 1)] if args.input else []
        if args.retractions:
            jobs.append((args.retractions, -1))
        for spec, sign in jobs:
            res = delta_mod.apply_batch(
                args.journal, open_source(spec, read_value=args.weighted),
                config, sign=sign, batch_size=args.batch_size,
                device=device)
            applied.append({
                "input": spec, "epoch": res.epoch, "points": res.points,
                "sign": res.sign, "duplicate": res.duplicate,
                "rows": res.rows,
                "affected_keys": len(res.affected_keys),
            })
        if applied:
            summary["applied"] = applied
        live = len(delta_mod.live_entries(args.journal))
        if args.compact_after is not None and live > args.compact_after:
            comp = delta_mod.compact(args.journal,
                                     retention=args.retention)
            summary["compaction"] = {
                k: comp.get(k) for k in ("status", "base",
                                         "applied_through", "rows",
                                         "pruned_entries")}
            live = len(delta_mod.live_entries(args.journal))
        summary["live_deltas"] = live
    except (ValueError, NotImplementedError) as e:
        # Config mismatch, double --base, an unported store feature:
        # operator errors, one line.
        tel.finish(error=e)
        raise SystemExit(str(e)) from e
    except BaseException as e:  # run_end must record it
        tel.finish(error=e)
        raise
    seconds = tel.finish(
        rows=int(sum(a["rows"] for a in summary.get("applied", []))))
    summary["seconds"] = round(seconds, 3)
    print(json.dumps(summary))
    return 0


def _add_retract_flags(p):
    p.add_argument("--journal", required=True, metavar="ROOT",
                   help="delta store root whose journal is scanned")
    p.add_argument("--where", action="append", default=[],
                   metavar="COL=VALUE",
                   help="equality clause on a point column (repeatable; "
                   "clauses AND). Columns: user/user_id, source, "
                   "timestamp, latitude, longitude, value")
    p.add_argument("--layer", default=None, metavar="USER",
                   help="shorthand for --where user=USER (the serve "
                   "tier's layer name)")
    p.add_argument("--batch-size", type=int, default=1 << 20)
    p.add_argument("--events", default=None, metavar="PATH",
                   help="append structured events to PATH "
                   "(retraction_applied, delta_applied)")


def cmd_retract(args) -> int:
    """Predicate retraction (delta/retract.py): scan the journal's point
    payloads for rows matching every --where clause, net them as a
    signed multiset, and apply exact sign=-1 counter-batches on the
    card, so the store converges to a clean recompute over the
    surviving points. Prints the JAX ``retract``'s summary keys."""
    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.delta import retract as retract_mod

    if args.no_x64:
        raise SystemExit("--no-x64: the composite-key cascade needs int64 "
                         "keys; drop --no-x64")
    device = _init_backend(args)
    pairs = list(args.where or [])
    if args.layer:
        pairs.append(f"user={args.layer}")
    try:
        where = retract_mod.parse_where(pairs)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    log = None
    if args.events:
        log = obs.EventLog(args.events)
        obs.set_event_log(log)
    try:
        summary = retract_mod.retract_predicate(
            args.journal, where, batch_size=args.batch_size, device=device)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e)) from e
    finally:
        if log is not None:
            obs.set_event_log(None)
            log.close()
    out = {k: v for k, v in summary.items() if k != "results"}
    out["journal"] = args.journal
    out["where"] = {k: str(v) for k, v in sorted(where.items())}
    out["seconds"] = round(out["seconds"], 3)
    print(json.dumps(out))
    return 0


def _add_ingest_flags(p):
    p.add_argument("--journal", required=True, metavar="ROOT",
                   help="delta store root the loop journals into "
                   "(created on first use; docs/ingest.md)")
    p.add_argument("--input", required=True,
                   help="source spec consumed as micro-batches (each one "
                   "journaled as its own signed epoch)")
    p.add_argument("--retract", action="store_true",
                   help="retract every batch instead of inserting "
                   "(sign=-1 epochs: counts are subtracted)")
    p.add_argument("--micro-batch", type=int, default=1 << 14,
                   help="points per tick (the journal/apply granularity)")
    p.add_argument("--queue-depth", type=int, default=4,
                   help="bounded-queue depth between the source reader "
                   "and the apply loop; a full queue blocks the reader "
                   "(back-pressure). 0 = synchronous, no reader thread")
    p.add_argument("--max-ticks", type=int, default=None,
                   help="stop after N ticks (default: drain the source)")
    p.add_argument("--compact-every", type=int, default=16, metavar="N",
                   help="fold the delta stack into a new base whenever N "
                   "live deltas accumulate (0 = never)")
    p.add_argument("--compact-max-age", type=float, default=0.0,
                   metavar="S",
                   help="also compact when the oldest live delta is "
                   "older than S seconds (0 = never)")
    p.add_argument("--retention", type=int, default=2,
                   help="journal entries kept after compaction as the "
                   "idempotency window")
    p.add_argument("--pad-bucketing", default="pow2",
                   choices=("pow2", "geometric", "exact"),
                   help="bucketed padding of the cascade's emissions "
                   "(pipeline/bucketing.py): pow2/geometric pad each "
                   "batch to a size bucket; exact follows the batch "
                   "(the same bytes either way)")
    p.add_argument("--pad-bucket-min", type=int, default=1 << 12,
                   help="bucket floor: batches below this many emissions "
                   "pad up to it")
    p.add_argument("--serve-port", type=int, default=None, metavar="PORT",
                   help="serve the store over HTTP while ingesting (0 = "
                   "ephemeral port): each applied tick publishes through "
                   "targeted cache invalidation (docs/serving.md)")
    p.add_argument("--detail-zoom", type=int, default=21)
    p.add_argument("--min-detail-zoom", type=int, default=5)
    p.add_argument("--result-delta", type=int, default=5)
    p.add_argument("--timespans", default="alltime")
    p.add_argument("--weighted", action="store_true",
                   help="sum the source's per-point 'value' column "
                   "instead of counting points")
    p.add_argument("--cascade-backend", default="auto",
                   choices=("auto", "scatter", "partitioned"))
    _add_parallel_flags(p)
    p.add_argument("--metrics-dir", default=None, metavar="DIR",
                   help="enable the metrics registry and write "
                   "DIR/metrics.prom at command end")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="append structured events to PATH (ingest_tick, "
                   "delta_applied, compaction_start/end; the JAX "
                   "package's schema)")
    p.add_argument("--report", nargs="?", const="run_report.json",
                   default=None, metavar="PATH",
                   help="fold tracer + metrics + events into a run report "
                   "at PATH and print the span table to stderr")
    _add_temporal_flags(p)
    _add_trace_flags(p)


def run_ingest_command(args, on_serve=None):
    """The ``ingest`` command: drain ``--input`` through the
    continuous-ingest loop (heatmap_tpu_torch.ingest) into the delta
    store at ``--journal``, each micro-batch journaled as a signed epoch
    and applied through the bucketed cascade on the card (the CPU with
    ``--backend cpu``). With ``--serve-port`` an in-process tile server
    over the store answers while the loop runs, and each applied tick
    publishes to it through targeted invalidation. A ``staleness`` SLO
    over tick recency rides the shared ``--slo`` flag, e.g. ``--slo
    fresh:staleness:max_age_s=30``.

    Returns ``(summary, stats)``: the summary that ``ingest`` prints
    (the JAX ``ingest``'s keys, then ``device``) and the loop's
    ``IngestStats`` (feeder numbers included). ``on_serve(app,
    base_url)``, when given, is called once the server is up."""
    from heatmap_tpu_torch import delta as delta_mod
    from heatmap_tpu_torch import ingest as ingest_mod
    from heatmap_tpu_torch.io import open_source
    from heatmap_tpu_torch.pipeline import bucketing
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    requested = tuple(t.strip() for t in args.timespans.split(",")
                      if t.strip())
    bad = [t for t in requested if t not in VALID_TYPES]
    if bad:
        raise SystemExit(
            f"--timespans: unknown type(s) {bad}; valid: "
            f"{', '.join(VALID_TYPES)}")
    if args.no_x64:
        raise SystemExit("--no-x64: the composite-key cascade needs int64 "
                         "keys; drop --no-x64")
    device = _init_backend(args)
    try:
        config = BatchJobConfig(
            detail_zoom=args.detail_zoom,
            min_detail_zoom=args.min_detail_zoom,
            result_delta=args.result_delta,
            timespans=requested,
            weighted=args.weighted,
            cascade_backend=args.cascade_backend,
            data_parallel=_DATA_PARALLEL[args.data_parallel],
            dispatch=args.dispatch,
            pad_bucketing=args.pad_bucketing,
            pad_bucket_min=args.pad_bucket_min,
        )
        ing = ingest_mod.IngestConfig(
            micro_batch=args.micro_batch,
            queue_depth=args.queue_depth or None,
            sign=-1 if args.retract else 1,
            compact_every=args.compact_every,
            compact_max_age_s=args.compact_max_age,
            retention=args.retention,
            max_ticks=args.max_ticks,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e
    tel = _Telemetry(args, "ingest", config, device, providers={
        "delta": lambda: {
            "journal": args.journal,
            "live_deltas": len(delta_mod.live_entries(args.journal))}})
    summary = {"journal": args.journal}
    server = None
    try:
        delta_mod.init_store(args.journal)
        tcfg = _ensure_temporal(args, args.journal)
        if tcfg is not None:
            summary["temporal"] = tcfg
        store = cache = None
        if args.serve_port is not None:
            from heatmap_tpu_torch.serve import (ServeApp, TileCache,
                                                 TileStore, serve_in_thread)

            store = TileStore(f"delta:{args.journal}")
            cache = TileCache()
            app = ServeApp(store, cache)
            server, base_url = serve_in_thread(app, port=args.serve_port)
            summary["serving"] = base_url
            print(f"serving {base_url}/tiles/... while ingesting",
                  file=sys.stderr)
            if on_serve is not None:
                on_serve(app, base_url)
        stats = ingest_mod.run_ingest(
            args.journal, open_source(args.input, read_value=args.weighted),
            config, ingest=ing, store=store, cache=cache, device=device)
        summary.update({
            "ticks": stats.ticks, "points": stats.points,
            "epochs": len(stats.epochs), "duplicates": stats.duplicates,
            "watermark": stats.watermark,
            "max_queue_depth": stats.max_queue_depth,
            "compactions": stats.compactions,
            "keys_invalidated": stats.keys_invalidated,
            "live_deltas": len(delta_mod.live_entries(args.journal)),
            "compile_cache": bucketing.cache_stats(),
        })
    except BaseException as e:  # run_end must record it
        error = e
    else:
        error = None
    finally:
        # End every connection (keep-alive ones too) before the event
        # log closes: a handler thread alive past the drain would emit
        # into a closed log.
        if server is not None:
            server.drain()
    if error is not None:
        tel.finish(error=error)
        if isinstance(error, (ValueError, NotImplementedError)):
            # A config mismatch or an unported store feature: one line.
            raise SystemExit(str(error)) from error
        raise error
    seconds = tel.finish(rows=int(summary.get("points", 0)))
    summary["seconds"] = round(seconds, 3)
    summary["device"] = device
    return summary, stats


def cmd_ingest(args) -> int:
    print(json.dumps(run_ingest_command(args)[0]))
    return 0


def _add_writeplane_flags(p):
    p.add_argument("--root", required=True, metavar="ROOT",
                   help="write-plane root (created on first use; serve "
                   "mounts it as writeplane:ROOT — docs/write-plane.md)")
    p.add_argument("--input", default=None,
                   help="insert source spec, drained as micro-batches "
                   "routed by Morton range")
    p.add_argument("--retractions", default=None,
                   help="retraction source spec (sign=-1 batches, "
                   "applied after --input)")
    p.add_argument("--writers", type=int, default=2,
                   help="ingest pumps = initial Morton ranges "
                   "(rebalance can add more)")
    p.add_argument("--micro-batch", type=int, default=1 << 14,
                   help="points per routed batch (the ledger/dedup "
                   "granularity — replays must use the same batching)")
    p.add_argument("--queue-depth", type=int, default=4,
                   help="bounded per-range queue depth between the "
                   "router and each pump")
    p.add_argument("--publish-every", type=int, default=1, metavar="N",
                   help="flip a manifest epoch every N finished batches")
    p.add_argument("--compact-every", type=int, default=16, metavar="N",
                   help="fold a range whenever N live deltas accumulate "
                   "(0 = never)")
    p.add_argument("--retention", type=int, default=2,
                   help="per-range journal entries kept after "
                   "compaction (refused below the retention floor or "
                   "the in-flight queue depth)")
    p.add_argument("--retention-floor", type=int, default=2,
                   help="hard floor under --retention (docs/"
                   "write-plane.md)")
    p.add_argument("--ledger-keep", type=int, default=64,
                   help="full-batch ledger entries retained (the "
                   "cross-rebalance dedup window)")
    p.add_argument("--max-ticks", type=int, default=None,
                   help="stop after N micro-batches (default: drain)")
    p.add_argument("--rebalance", action="store_true",
                   help="run one skew-triggered hot-range re-split "
                   "after the drain (docs/write-plane.md runbook)")
    p.add_argument("--pad-bucketing", default="pow2",
                   choices=("pow2", "geometric", "exact"),
                   help="bucketed padding of each routed sub-batch "
                   "(pipeline/bucketing.py): pow2/geometric pad to a "
                   "size bucket with masked-invalid lanes; exact follows "
                   "the sub-batch (the same bytes either way)")
    p.add_argument("--pad-bucket-min", type=int, default=1 << 12,
                   help="bucket floor: sub-batches below this many "
                   "emissions pad up to it")
    p.add_argument("--detail-zoom", type=int, default=21)
    p.add_argument("--min-detail-zoom", type=int, default=5)
    p.add_argument("--result-delta", type=int, default=5)
    p.add_argument("--timespans", default="alltime")
    p.add_argument("--weighted", action="store_true")
    p.add_argument("--cascade-backend", default="auto",
                   choices=("auto", "scatter", "partitioned"))
    _add_parallel_flags(p)
    p.add_argument("--metrics-dir", default=None, metavar="DIR",
                   help="enable the metrics registry and write "
                   "DIR/metrics.prom at command end")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="append structured events to PATH "
                   "(writeplane_append/publish/rebalance — "
                   "docs/observability.md)")
    p.add_argument("--report", nargs="?", const="run_report.json",
                   default=None, metavar="PATH")
    _add_trace_flags(p)


def cmd_writeplane(args) -> int:
    """Partitioned multi-writer ingest (heatmap_tpu_torch.writeplane):
    batches route by Morton range to independent per-range delta stores,
    one pump thread each, every routed sub-batch's cascade on the card
    (the CPU with ``--backend cpu``), unified for readers by an
    epoch-flipped manifest. Serve mounts the root as ``writeplane:ROOT``.
    Prints the JAX ``writeplane``'s summary, then ``device``."""
    import statistics

    from heatmap_tpu_torch import writeplane as wp_mod
    from heatmap_tpu_torch.io import open_source
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    requested = tuple(t.strip() for t in args.timespans.split(",")
                      if t.strip())
    bad = [t for t in requested if t not in VALID_TYPES]
    if bad:
        raise SystemExit(f"--timespans: unknown type(s) {bad}; valid: "
                         f"{', '.join(VALID_TYPES)}")
    if args.no_x64:
        raise SystemExit("--no-x64: the composite-key cascade needs int64 "
                         "keys; drop --no-x64")
    device = _init_backend(args)
    try:
        config = BatchJobConfig(
            detail_zoom=args.detail_zoom,
            min_detail_zoom=args.min_detail_zoom,
            result_delta=args.result_delta,
            timespans=requested,
            weighted=args.weighted,
            cascade_backend=args.cascade_backend,
            data_parallel=_DATA_PARALLEL[args.data_parallel],
            dispatch=args.dispatch,
            pad_bucketing=args.pad_bucketing,
            pad_bucket_min=args.pad_bucket_min,
        )
        plane_cfg = wp_mod.PlaneConfig(
            n_writers=args.writers,
            retention=args.retention,
            retention_floor=args.retention_floor,
            compact_every=args.compact_every,
            ledger_keep=args.ledger_keep,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e
    tel = _Telemetry(args, "writeplane", config, device, providers={
        "writeplane": lambda: {"root": args.root,
                               "epoch": wp_mod.read_pointer(args.root)}})
    summary = {"root": args.root}
    try:
        plane = wp_mod.WritePlane(args.root, config, plane_cfg,
                                  device=device)
        runs = []
        jobs = [(args.input, 1)] if args.input else []
        if args.retractions:
            jobs.append((args.retractions, -1))
        for spec, sign in jobs:
            stats = wp_mod.run_plane_ingest(
                plane, open_source(spec, read_value=args.weighted),
                micro_batch=args.micro_batch, sign=sign,
                queue_depth=args.queue_depth,
                publish_every=args.publish_every,
                max_ticks=args.max_ticks)
            runs.append({
                "input": spec, "sign": sign, "batches": stats.batches,
                "completed": stats.completed,
                "duplicates": stats.duplicates, "failed": stats.failed,
                "points": stats.points, "publishes": stats.publishes,
                "publish_errors": stats.publish_errors,
                "lag_p50_s": (round(statistics.median(stats.lags_s), 6)
                              if stats.lags_s else None),
            })
        if runs:
            summary["runs"] = runs
        if args.rebalance:
            rb = plane.rebalance()
            summary["rebalance"] = (
                None if rb is None else
                {k: rb[k] for k in ("range", "new_range", "split",
                                    "epoch")})
        summary["epoch"] = plane.publish()
        summary["ranges"] = plane.order
    except ValueError as e:
        tel.finish(error=e)
        raise SystemExit(str(e)) from e
    except BaseException as e:  # run_end must record it
        tel.finish(error=e)
        raise
    seconds = tel.finish(rows=int(sum(r["points"] for r in
                                      summary.get("runs", []))))
    summary["seconds"] = round(seconds, 3)
    summary["device"] = device
    print(json.dumps(summary))
    return 0


def _parse_layers(arg: str | None):
    """``--layers name=user|timespan,...`` -> {name: selector} or None
    (= expose every slice + the 'default' alias)."""
    if not arg:
        return None
    layers = {}
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, sel = part.partition("=")
        layers[name.strip()] = (sel if sep else name).strip()
    return layers or None


class LivePump:
    """``serve --follow-stream``: micro-batches of the source pumped into
    a LiveLayer on a daemon thread (the only thread that touches the
    card); each tick invalidates only the cache keys of the tiles the
    batch touched. ``thread`` ends when the source does; ``stop()``
    ends it early."""

    def __init__(self, args, app, device):
        import threading

        import torch

        from heatmap_tpu_torch.io import open_source
        from heatmap_tpu_torch.ops.histogram import window_from_bounds
        from heatmap_tpu_torch.pipeline.batch import load_columns
        from heatmap_tpu_torch.serve import LiveLayer
        from heatmap_tpu_torch.streaming import HeatmapStream, StreamConfig

        window = window_from_bounds(
            (args.lat_min, args.lat_max), (args.lon_min, args.lon_max),
            zoom=args.zoom)
        config = StreamConfig(
            window=window,
            half_life_s=args.half_life,
            proj_dtype=torch.float32 if args.no_x64 else torch.float64,
            pad_to=args.batch_points,
        )
        self.layer = LiveLayer(HeatmapStream(config, device=device),
                               name=args.live_layer)
        app.attach_layer(args.live_layer, self.layer)
        self.ticks = 0
        self._done = threading.Event()

        def _pump():
            t_stream = 0.0
            source = open_source(args.follow_stream, read_value=False)
            for batch in source.batches(args.batch_points):
                if self._done.is_set():
                    break
                cols = load_columns(batch)
                t_stream += args.interval
                keys = self.layer.tick(cols["latitude"], cols["longitude"],
                                       t_stream)
                app.cache.invalidate_matching(keys)
                self.ticks += 1
                if args.tick_seconds > 0:
                    self._done.wait(args.tick_seconds)

        self.thread = threading.Thread(target=_pump, name="serve-stream",
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self._done.set()
        self.thread.join(timeout=5)


@dataclasses.dataclass
class ServeHandle:
    """What ``serve`` has set up before it blocks: the bound (not yet
    serving) server, its app (the fleet's router under --fleet), the
    live pump (None without --follow-stream), the stderr banner, the
    resolved device (None when the command does no device work) and the
    fleet's supervisor (None without --fleet)."""

    server: object
    app: object
    live: LivePump | None
    banner: dict
    device: str | None
    args: argparse.Namespace
    collector: object = None
    ev_log: object = None
    fleet: object = None

    def close(self):
        """Stop the pump, close the socket, stop the fleet, export the
        trace and close the event log: ``serve``'s exit path."""
        from heatmap_tpu_torch import obs

        if self.live is not None:
            self.live.stop()
        self.server.server_close()
        if self.fleet is not None:
            self.fleet.stop()
        obs.timeseries.shutdown()
        if self.collector is not None:
            n = self.collector.export_chrome(self.args.trace_out)
            print(json.dumps({"trace_out": self.args.trace_out,
                              "span_events": n,
                              "dropped": self.collector.dropped}),
                  file=sys.stderr)
        if self.ev_log is not None:
            obs.set_event_log(None)
            self.ev_log.close()


def start_serve(args) -> ServeHandle:
    """Everything ``serve`` does before ``serve_forever``: the store, the
    cache, the brownout ladder, the disk tier and pre-warm, the app and
    (with --follow-stream) the live pump, then the bound server and the
    startup pre-warm; under --fleet the supervisor with its backends and
    the router instead (``_start_fleet``). Without --follow-stream
    nothing here touches torch.cuda, as the JAX package never starts a
    backend for ``serve``: a tile server stays up beside a busy or dead
    card."""
    from heatmap_tpu_torch import faults, obs
    from heatmap_tpu_torch.serve import (ServeApp, TileCache, TileStore,
                                         make_server)
    from heatmap_tpu_torch.serve import degrade as degrade_mod

    # serve skips _init_backend unless it follows a stream: arm chaos here.
    faults.install_from_env(getattr(args, "chaos", None))
    # /metrics is a first-class endpoint here, not an opt-in artifact.
    obs.enable_metrics(True)
    ev_log = None
    if args.events:
        ev_log = obs.EventLog(args.events)
        obs.set_event_log(ev_log)
    collector = _setup_tracing(args)
    if args.fleet:
        if args.follow_stream:
            raise SystemExit("--fleet is incompatible with --follow-stream "
                             "(live layers are per-process state)")
        return _start_fleet(args, collector, ev_log)
    ttl = args.ttl
    if args.follow_stream and not (ttl and ttl > 0):
        # Targeted invalidation only drops tiles a batch touched; decay
        # drifts every OTHER cached tile, so live mode needs its
        # staleness bounded by a finite TTL (serve/live.py).
        ttl = max(1.0, args.interval / 2)
    try:
        store = TileStore(args.store, layers=_parse_layers(args.layers))
    except (ValueError, OSError) as e:
        raise SystemExit(str(e)) from e
    cache = TileCache(max_bytes=args.cache_bytes,
                      ttl_s=ttl if (ttl and ttl > 0) else None)
    try:
        controller = degrade_mod.controller_from_flags(
            args.degrade, args.degrade_dwell, args.degrade_hold,
            args.degrade_ladder)
    except ValueError as e:
        raise SystemExit(f"--degrade-ladder: {e}") from e
    disk_cache = prewarm = None
    if args.disk_cache:
        from heatmap_tpu_torch.tilefs import DiskTileCache

        disk_cache = DiskTileCache(args.disk_cache,
                                   max_bytes=args.disk_cache_bytes)
    if args.prewarm_events:
        from heatmap_tpu_torch.tilefs import PrewarmConfig

        prewarm = PrewarmConfig(events=tuple(args.prewarm_events),
                                top_k=args.prewarm_top_k,
                                budget_s=args.prewarm_budget_s,
                                budget_bytes=args.prewarm_bytes)
    app = ServeApp(store, cache, render_timeout_s=args.render_timeout,
                   synopsis_default=args.synopsis_default,
                   degrade=controller, disk_cache=disk_cache,
                   prewarm=prewarm)
    # Incident bundles capture the same state /healthz serves, plus the
    # mount fingerprint (no-ops without --incident-dir).
    obs.incident.add_state_provider("healthz", app._health)
    obs.incident.add_state_provider("config", lambda: {
        "store": args.store, "layers": app.layer_names(),
        "cache_bytes": cache.max_bytes, "ttl_s": cache.ttl_s})
    live = device = None
    if args.follow_stream:
        from heatmap_tpu_torch.devices import resolve_device

        device = _init_backend(args)
        live = LivePump(args, app, resolve_device(device))
    server = make_server(app, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    # Warm before announcing readiness on stderr: a supervisor that
    # waits for the banner sees a server whose popular tiles are hot.
    app.prewarm_now(source="startup")
    banner = {
        "serving": f"http://{host}:{port}",
        "store": args.store,
        "layers": app.layer_names(),
        "cache_bytes": cache.max_bytes,
        "ttl_s": cache.ttl_s,
        "device": device,
    }
    return ServeHandle(server, app, live, banner, device, args,
                       collector=collector, ev_log=ev_log)


def _start_fleet(args, collector, ev_log) -> ServeHandle:
    """``serve --fleet N``: the supervisor (N child serve processes over
    the same store, each with its own LRU) and the router on
    --host/--port, fronting them with the rendezvous ring, breakers,
    hedging and admission control (docs/serving.md)."""
    from heatmap_tpu_torch.obs import incident as incident_mod
    from heatmap_tpu_torch.serve import degrade as degrade_mod
    from heatmap_tpu_torch.serve import make_server
    from heatmap_tpu_torch.serve.fleet import FleetSupervisor

    degrade_opts = None
    if args.degrade:
        degrade_opts = {"dwell_s": args.degrade_dwell,
                        "hold_s": args.degrade_hold,
                        "ladder_spec": args.degrade_ladder}
        try:
            # Fail fast in the supervisor, not in every backend child.
            degrade_mod.parse_ladder_spec(degrade_opts["ladder_spec"])
        except ValueError as e:
            raise SystemExit(f"--degrade-ladder: {e}") from e
    supervisor = FleetSupervisor(
        args.store, args.fleet,
        host=args.host, cache_bytes=args.cache_bytes,
        backend_max_inflight=args.max_inflight,
        render_timeout_s=args.render_timeout,
        chaos=args.chaos,
        max_inflight=args.max_inflight or 32,
        queue_deadline_s=args.queue_deadline,
        hedge_quantile=args.hedge_quantile,
        probe_interval_s=args.probe_interval,
        degrade_opts=degrade_opts,
        slo_specs=list(args.slo or []),
        telemetry_opts=(
            {"interval": args.telemetry_sample_interval,
             "watches": list(args.watch or [])}
            if args.telemetry_sample_interval else None),
        disk_cache_opts=({"root": args.disk_cache,
                          "max_bytes": args.disk_cache_bytes}
                         if args.disk_cache else None),
        prewarm_opts=({"events": list(args.prewarm_events),
                       "top_k": args.prewarm_top_k,
                       "budget_s": args.prewarm_budget_s,
                       "budget_bytes": args.prewarm_bytes}
                      if args.prewarm_events else None))
    # Lazy: supervisor.router is None until supervisor.start() below.
    incident_mod.add_state_provider(
        "healthz",
        lambda: supervisor.router._health() if supervisor.router else {})
    incident_mod.add_state_provider("config", lambda: {
        "store": args.store, "fleet": args.fleet,
        "backends": {bid: c.address for bid, c
                     in supervisor.router.backends.items()}})
    supervisor.start()
    try:
        server = make_server(supervisor.router, host=args.host,
                             port=args.port)
    except BaseException:
        supervisor.stop()
        raise
    host, port = server.server_address[:2]
    banner = {
        "serving": f"http://{host}:{port}",
        "store": args.store,
        "fleet": {bid: client.address for bid, client
                  in supervisor.router.backends.items()},
        "device": None,
    }
    return ServeHandle(server, supervisor.router, None, banner, None, args,
                       collector=collector, ev_log=ev_log, fleet=supervisor)


def cmd_serve(args) -> int:
    """Tile HTTP server over a stored heatmap artifact (docs/serving.md):
    the JAX ``serve``'s flags and banner (then ``device``). Numpy only
    unless --follow-stream is given."""
    handle = start_serve(args)
    print(json.dumps(handle.banner), file=sys.stderr, flush=True)
    try:
        handle.server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        handle.close()
    return 0


def run_render(args) -> dict:
    """The ``render`` command: one (user, timespan, zoom) slice of a
    stored artifact (``arrays:DIR``, ``arrays-parquet:DIR`` or
    ``jsonl:PATH``) drawn as a z/x/y PNG tile tree from the stored
    counts, with no re-aggregation and no device work. Returns the
    summary it prints: the JAX ``render``'s keys, then ``device``
    (None)."""
    import numpy as np

    from heatmap_tpu_torch.io import PNGTileSink
    from heatmap_tpu_torch.io.sinks import JSONLBlobSink, LevelArraysSink

    kind, _, rest = args.input.partition(":")
    if kind in ("arrays", "arrays-parquet"):
        levels = LevelArraysSink.load(rest)
        if not levels:
            raise SystemExit(f"no level files under {rest!r}")
        zoom = args.zoom if args.zoom is not None else max(levels)
        if zoom not in levels:
            raise SystemExit(
                f"zoom {zoom} not stored; available: {sorted(levels)}")
        lvl = levels[zoom]
        keep = ((lvl["user"] == args.user)
                & (lvl["timespan"] == args.timespan))
        rows = lvl["row"][keep].astype(np.int64)
        cols = lvl["col"][keep].astype(np.int64)
        vals = lvl["value"][keep]
    elif kind == "jsonl" or args.input.endswith((".jsonl", ".ndjson")):
        from heatmap_tpu_torch.tilemath.keys import parse_tile_id

        path = rest if kind == "jsonl" else args.input
        blobs = JSONLBlobSink.load(path)
        # One pass: collect every matching (z, r, c, v); pick/filter the
        # zoom afterwards. Malformed ids drop, as the reference parser.
        entries = []
        for blob_id, heat in blobs.items():
            user, ts, _coarse = blob_id.split("|", 2)
            if user != args.user or ts != args.timespan:
                continue
            for tile_id, v in heat.items():
                parsed = parse_tile_id(tile_id)
                if parsed is not None:
                    entries.append((*parsed, float(v)))
        zooms_seen = {e[0] for e in entries}
        zoom = args.zoom if args.zoom is not None else (
            max(zooms_seen) if zooms_seen else None)
        if zoom is None or zoom not in zooms_seen:
            raise SystemExit(
                f"zoom {zoom} not stored for "
                f"{args.user!r}/{args.timespan!r}; "
                f"available: {sorted(zooms_seen)}")
        sel = [e for e in entries if e[0] == zoom]
        rows = np.asarray([e[1] for e in sel], np.int64)
        cols = np.asarray([e[2] for e in sel], np.int64)
        vals = np.asarray([e[3] for e in sel], np.float64)
    else:
        raise SystemExit(
            f"render input must be arrays:DIR, arrays-parquet:DIR or "
            f"jsonl:PATH, got {args.input!r}")

    if len(rows) == 0:
        return {"tiles": 0, "output": args.output, "user": args.user,
                "timespan": args.timespan, "device": None}
    pixel_delta = min(args.pixel_delta, zoom)
    px = 1 << pixel_delta
    # Rasterize PER OCCUPIED OUTPUT TILE, not over one bounding box: per-
    # tile blocks bound memory at px*px regardless of extent. One shared
    # vmax keeps the colormap consistent across tiles.
    from heatmap_tpu_torch.ops.histogram import Window

    t0 = time.perf_counter()
    tile_key = (rows // px) * (1 << 40) + (cols // px)
    order = np.argsort(tile_key, kind="stable")
    sorted_keys = tile_key[order]
    starts = np.flatnonzero(
        np.concatenate([[True], sorted_keys[1:] != sorted_keys[:-1]]))
    bounds = np.append(starts, len(sorted_keys))
    sink = PNGTileSink(args.output, pixel_delta=pixel_delta)
    vmax = float(vals.max())
    n = 0
    for k, s in enumerate(starts):
        sel = order[s:bounds[k + 1]]
        ty = int(rows[sel[0]]) // px
        tx = int(cols[sel[0]]) // px
        block = np.zeros(px * px, np.float64)
        np.add.at(block, (rows[sel] - ty * px) * px + (cols[sel] - tx * px),
                  vals[sel])
        window = Window(zoom=zoom, row0=ty * px, col0=tx * px,
                        height=px, width=px)
        n += sink.write_window(block.reshape(px, px), window, vmax=vmax)
    return {
        "tiles": n,
        "tile_zoom": zoom - pixel_delta,
        "zoom": zoom,
        "aggregates": int(len(rows)),
        "seconds": round(time.perf_counter() - t0, 3),
        "output": args.output,
        "device": None,
    }


def cmd_render(args) -> int:
    print(json.dumps(run_render(args)))
    return 0


def cmd_run(args) -> int:
    import contextlib

    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline.batch import (
        BatchJobConfig,
        run_job,
        run_job_fast,
        run_job_resumable,
    )
    from heatmap_tpu_torch.utils.trace import get_tracer, torch_profile

    if args.no_x64:
        # The JAX package's run ends the same way, with exit code 1
        # (heatmap_tpu/pipeline/cascade.py composite_keys).
        raise SystemExit(
            "--no-x64: the composite-key cascade needs int64 keys; drop "
            "--no-x64 (it applies to tiles and stream only)")
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
            data_parallel=_DATA_PARALLEL[args.data_parallel],
            dp_merge=args.dp_merge,
            dp_min_emissions=args.dp_min_emissions,
            spatial_partition=args.spatial_partition,
            dispatch=args.dispatch,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e
    _check_run_parallel_flags(args)
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
    _init_backend(args)
    fast_source = None if args.multihost else _fast_source(args)
    output_spec = args.output
    if args.multihost:
        from heatmap_tpu_torch import parallel
        from heatmap_tpu_torch.devices import process_index

        # Join the cluster (if one is configured) before anything else;
        # a configured cluster that fails to join raises.
        parallel.initialize()
        if args.multihost_egress == "sharded":
            # Every process writes its own shard of the output.
            from heatmap_tpu_torch.io.sinks import per_process_sink_spec

            output_spec = per_process_sink_spec(args.output,
                                                process_index())
    tel = _Telemetry(args, "run", config, args.device)
    prof = (torch_profile(args.profile) if args.profile
            else contextlib.nullcontext())
    try:
        with prof, open_sink(output_spec) as sink:
            if fast_source is not None:
                blobs = run_job_fast(
                    fast_source, sink, config, batch_size=args.batch_size,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    max_points_in_flight=args.max_points_in_flight,
                    merge_spill_dir=args.merge_spill_dir,
                    device=args.device)
            elif args.checkpoint_dir:
                blobs = run_job_resumable(
                    open_source(args.input, read_value=args.weighted),
                    args.checkpoint_dir, sink, config,
                    batch_size=args.batch_size,
                    checkpoint_every=args.checkpoint_every,
                    device=args.device)
            elif args.multihost:
                from heatmap_tpu_torch.parallel import run_job_multihost

                blobs = run_job_multihost(
                    open_source(args.input, read_value=args.weighted),
                    sink, config, batch_size=args.batch_size,
                    max_points_in_flight=args.max_points_in_flight,
                    egress=args.multihost_egress,
                    merge_spill_dir=args.merge_spill_dir,
                    heartbeat_deadline_s=args.heartbeat_deadline,
                    on_straggler=args.on_straggler,
                    elastic_dir=args.elastic_dir,
                    elastic_hosts=args.elastic_hosts,
                    device=args.device)
            else:
                blobs = run_job(
                    open_source(args.input, read_value=args.weighted),
                    sink, config, batch_size=args.batch_size,
                    max_points_in_flight=args.max_points_in_flight,
                    merge_spill_dir=args.merge_spill_dir,
                    device=args.device)
    except BaseException as e:  # run_end must record it
        tel.finish(error=e, sample_memory=True)
        raise
    # "levels" (columnar), "levels-sharded" (multihost columnar) and
    # "levels-elastic" (elastic reassignment).
    levels = str(blobs.get("egress", "")).startswith("levels")
    if levels:
        end = {"levels": blobs["levels"], "rows": blobs["rows"]}
    else:
        end = {"blobs": len(blobs)}
        if tel.log is not None:
            end["checksum"] = obs.blob_checksum(blobs)
    seconds = tel.finish(sample_memory=True, **end)
    if args.profile:
        print(get_tracer().format_report(), file=sys.stderr)
    summary = {"seconds": round(seconds, 3), "output": output_spec,
               "ingest": "fast" if fast_source is not None else "standard"}
    if levels:
        summary["levels"] = blobs["levels"]
        summary["rows"] = blobs["rows"]
    else:
        summary["blobs"] = len(blobs)
    summary["device"] = args.device
    summary["cascade_backend"] = config.resolved_cascade_backend(args.device)
    print(json.dumps(summary))
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

    device = resolve_device(_device(args))
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
    _init_backend(args)
    print(json.dumps(run_tiles(args)[0]))
    return 0


def _live_dir(args) -> str:
    """Root for runtime tile artifacts (the --live-dir knob): explicit
    flag > checkpoint dir > system tmp, never the working directory."""
    if getattr(args, "live_dir", None):
        return args.live_dir
    if getattr(args, "checkpoint_dir", None):
        return args.checkpoint_dir
    import tempfile

    return os.path.join(tempfile.gettempdir(), "heatmap-tpu")


def run_stream_command(args, source=None):
    """The ``stream`` command: the source as micro-batches of
    ``--batch-points`` points, ``--interval`` stream seconds apart,
    through a decaying window raster on ``args.device``, checkpointed
    every ``--checkpoint-every`` batches, and its final snapshot written
    as a PNG tile tree. A rerun with the same checkpoint dir replays the
    source up to the checkpoint and goes on from there.

    Returns ``(summary, snapshot, stream)``: the summary that ``stream``
    prints (the JAX package's keys, then the device, the resolved
    binning backend and the milliseconds of each stage), the final raster
    on the host and the HeatmapStream (both None when --auto-bounds
    finds no point). ``source``, an opened io Source, replaces
    ``args.input`` for callers that build their own."""
    if args.output is None:
        args.output = os.path.join(_live_dir(args), "live_tiles")
    if args.half_life <= 0:
        raise SystemExit(f"--half-life {args.half_life}: must be positive")
    if args.zoom < args.pixel_delta:
        raise SystemExit(
            f"--zoom {args.zoom} must be >= --pixel-delta {args.pixel_delta} "
            "(tile zoom = zoom - pixel_delta)"
        )
    if args.checkpoint_dir and args.checkpoint_every < 1:
        raise SystemExit(
            f"--checkpoint-every {args.checkpoint_every}: must be >= 1"
        )
    import numpy as np
    import torch

    from heatmap_tpu_torch.devices import StageTimer, resolve_device
    from heatmap_tpu_torch.io import PNGTileSink, open_source
    from heatmap_tpu_torch.ops.histogram import _pick_backend
    from heatmap_tpu_torch.pipeline.batch import load_columns
    from heatmap_tpu_torch.streaming import HeatmapStream, StreamConfig
    from heatmap_tpu_torch.utils import CheckpointManager

    device = resolve_device(_device(args))
    if args.auto_bounds:
        # Needs a re-iterable (file) source; the same file on resume
        # gives the same window (restore() rejects a shifted one).
        bounds = _scan_bounds(
            source or open_source(args.input, read_value=False),
            args.batch_points)
        if bounds is None:
            return {"batches": 0, "stream_seconds": 0.0, "live_mass": 0.0,
                    "tiles": 0, "seconds": 0.0, "output": args.output}, \
                None, None
        args.lat_min, args.lat_max, args.lon_min, args.lon_max = bounds
    window = tiles_window(args)
    config = StreamConfig(
        window=window,
        half_life_s=args.half_life,
        proj_dtype=torch.float32 if args.no_x64 else torch.float64,
        pad_to=args.batch_points,
        backend=args.bin_backend,
    )
    stream = HeatmapStream(config, device=device)
    mgr = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        if mgr.latest_step() is not None:
            stream.restore(mgr, weighted=args.weighted)
    timer = StageTimer(device)
    t0 = time.perf_counter()
    resumed = stream.n_batches
    t_stream = stream.t or 0.0
    if source is None:
        source = open_source(args.input, read_value=args.weighted)
    batches = iter(source.batches(args.batch_points))
    i = 0
    while True:
        with timer.stage("ingest"):
            batch = next(batches, None)
            i += 1
            if batch is None or i <= resumed:
                # Past the end, or deterministic source replay up to
                # the checkpoint.
                cols = None
            else:
                cols = load_columns(batch)
                if args.weighted and "value" not in cols:
                    raise SystemExit(
                        "--weighted needs a 'value' column in the input "
                        "(CSV/JSONL/Parquet column named 'value')"
                    )
        if batch is None:
            break
        if cols is None:
            continue
        t_stream += args.interval
        with timer.stage("update"):
            stream.update(cols["latitude"], cols["longitude"], t_stream,
                          weights=cols["value"] if args.weighted else None)
        if mgr is not None and stream.n_batches % args.checkpoint_every == 0:
            with timer.stage("checkpoint"):
                stream.checkpoint(mgr, weighted=args.weighted)
    with timer.stage("egress"):
        if mgr is not None:
            stream.checkpoint(mgr, weighted=args.weighted)
        snap = stream.snapshot()  # one device->host copy, reused below
        n_tiles = 0
        if args.output:
            sink = PNGTileSink(args.output, pixel_delta=args.pixel_delta)
            n_tiles = sink.write_window(snap, window)
    summary = {
        "batches": stream.n_batches,
        "stream_seconds": stream.t,
        "live_mass": float(np.sum(snap)),
        "bounds": [round(args.lat_min, 6), round(args.lat_max, 6),
                   round(args.lon_min, 6), round(args.lon_max, 6)],
        "tiles": n_tiles,
        "seconds": round(time.perf_counter() - t0, 3),
        "output": args.output,
        "device": str(device),
        "window": [window.height, window.width],
        "bin_backend": _pick_backend(args.bin_backend, window, device),
        "stage_ms": {k: sum(v) for k, v in timer.ms.items()},
    }
    return summary, snap, stream


def cmd_stream(args) -> int:
    _init_backend(args)
    print(json.dumps(run_stream_command(args)[0]))
    return 0


def cmd_merge(args) -> int:
    """Merge per-host egress shards into one artifact (no device)."""
    from heatmap_tpu_torch.io.merge import merge_blob_files, merge_level_dirs
    from heatmap_tpu_torch.io.sinks import LevelArraysSink, open_sink

    dirs = [os.path.isdir(p) for p in args.inputs]
    columnar_out = args.output.startswith("arrays:")
    if all(dirs):
        if not columnar_out:
            # Level arrays through a blob spec would write a directory of
            # .npz files under a name the operator takes for a file.
            raise SystemExit(
                "level-array inputs merge into a columnar sink; pass "
                "--output arrays:DIR (got "
                f"{args.output!r})"
            )
        levels = merge_level_dirs(args.inputs)
        rows = LevelArraysSink(
            args.output[len("arrays:"):]
        ).write_levels(levels)
        print(json.dumps({"mode": "levels", "inputs": len(args.inputs),
                          "levels": len(levels), "rows": rows,
                          "output": args.output}))
        return 0
    if any(dirs):
        raise SystemExit(
            "merge inputs must be all JSONL blob files or all "
            "level-array directories, not a mix"
        )
    if columnar_out:
        raise SystemExit(
            "blob inputs merge into a blob sink (jsonl:/dir:/memory:); "
            f"arrays: is columnar-only (got {args.output!r})"
        )
    blobs = merge_blob_files(args.inputs)
    with open_sink(args.output) as sink:
        sink.write((k, json.dumps(v)) for k, v in blobs.items())
    print(json.dumps({"mode": "blobs", "inputs": len(args.inputs),
                      "blobs": len(blobs), "output": args.output}))
    return 0


def cmd_info(args) -> int:
    """The backend and its devices as one JSON line. Device discovery
    runs on a daemon thread bounded by ``--probe-timeout``; a backend
    that does not answer, or a card that is not there, is reported as
    JSON instead of hanging or raising."""
    if args.device_timeout:
        args.probe_timeout = args.device_timeout
    args.device_timeout = 0.0
    device = _init_backend(args)
    import threading

    import torch

    import heatmap_tpu_torch
    from heatmap_tpu_torch import native

    dev_info = {}

    def _probe():
        if device == "cpu":
            dev_info.update(platform="cpu", n_devices=1, n_processes=1)
        elif not torch.cuda.is_available():
            dev_info.update(
                platform="unavailable", n_devices=0,
                note="torch.cuda.is_available() is False; rerun with "
                     "--backend cpu for host info")
        else:
            dev_info.update(platform="cuda",
                            n_devices=torch.cuda.device_count(),
                            n_processes=1)

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout=args.probe_timeout)
    if t.is_alive():
        dev_info = {"platform": "unreachable", "n_devices": 0,
                    "note": f"backend init exceeded {args.probe_timeout:.0f}s; "
                            "rerun with --backend cpu for host info"}
    print(json.dumps({
        "backend": args.backend,
        **dev_info,
        "x64": not args.no_x64,
        "native": native.available(),
        "version": heatmap_tpu_torch.__version__,
    }))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
