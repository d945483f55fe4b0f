"""Telemetry: metrics registry, structured events, span trees, run report.

The port's copy of the core of heatmap_tpu/obs (docs/observability.md):

- ``obs.metrics``: process-wide counters, gauges and histograms with
  labels and a Prometheus-text writer (``--metrics-dir``);
- ``obs.events``: append-only JSONL run events with the JAX package's
  pinned schema (``--events``);
- ``obs.tracing``: hierarchical span trees with Chrome/Perfetto export
  (``--trace-out``, ``--trace-sample``);
- ``obs.report``: folds tracer, registry and events into
  ``run_report.json`` and a table (``--report``);
- ``obs.recorder``: the flight recorder, bounded rings of completed
  spans and events with tail-based promotion
  (``--flight-recorder-spans``, ``--tail-latency-ms``);
- ``obs.slo``: declarative SLOs with burn rates over the event stream
  (``--slo``);
- ``obs.incident``: incident bundles flushed on failure edges
  (``--incident-dir``);
- ``obs.timeseries``: the tiered in-process time-series store and its
  background sampler (``--telemetry-sample-interval``);
- ``obs.anomaly``: EWMA + MAD z-score watches over sampled series
  (``--watch``).

This module owns the shared metric handles (created once on the default
registry; ``registry.reset()`` clears values and keeps these objects
valid) and the recorders that instrumentation sites call. Every
recorder is a no-op while neither the registry is enabled nor an event
log installed, so with telemetry off the pipeline pays a global read or
two per site and writes the same bytes.

The serve tier's process gauges (``refresh_process_gauges``, stamped at
every ``/metrics`` scrape) and the partition planner's recorder
(``record_partition_planned``, which the write plane's planning reaches)
are here too; the multihost recorders (heartbeats, shard retries,
elastic shards, speculative launches) wait for the rest of
``parallel/`` (item 7): the port has one process, index 0 of 1.
"""

from __future__ import annotations

import time

from heatmap_tpu_torch.obs import (anomaly, events, incident, metrics,
                                   recorder, slo, timeseries, tracing)
from heatmap_tpu_torch.obs.anomaly import (AnomalyEngine, WatchSpec,
                                           parse_watch_spec)
from heatmap_tpu_torch.obs.events import (EVENT_SCHEMA, EventLog, emit,
                                          get_event_log, read_events,
                                          set_event_log, validate_event)
from heatmap_tpu_torch.obs.incident import IncidentManager
from heatmap_tpu_torch.obs.metrics import (MetricsRegistry, enable_metrics,
                                           get_registry, metrics_enabled)
from heatmap_tpu_torch.obs.recorder import FlightRecorder
from heatmap_tpu_torch.obs.report import (blob_checksum, build_run_report,
                                          format_run_report,
                                          write_run_report)
from heatmap_tpu_torch.obs.slo import (SLOEngine, SLOSpec, install_specs,
                                       parse_slo_spec, slo_status)
from heatmap_tpu_torch.obs.timeseries import TelemetrySampler, TimeSeriesStore
from heatmap_tpu_torch.obs.tracing import (TraceCollector, current_span,
                                           current_traceparent,
                                           disable_tracing, enable_tracing,
                                           get_collector, parse_traceparent,
                                           tracing_enabled)

_registry = get_registry()

# -- shared metric handles (one definition per series, reused everywhere);
# the JAX package's names, help texts and labels --
STAGE_SECONDS = _registry.histogram(
    "stage_duration_seconds", "Host wall-clock per tracer span",
    labelnames=("stage",))
STAGE_ITEMS = _registry.counter(
    "stage_items_total", "Items attributed to tracer spans",
    labelnames=("stage",))
POINTS_BINNED = _registry.counter(
    "points_binned_total", "Emissions routed into the cascade",
    labelnames=("backend",))
SOURCE_ROWS = _registry.counter(
    "source_rows_read_total", "Rows yielded by io sources",
    labelnames=("source",))
SINK_BLOBS = _registry.counter(
    "sink_blobs_written_total", "Blobs written by io sinks",
    labelnames=("sink",))
SINK_ROWS = _registry.counter(
    "sink_rows_written_total", "Tile rows written by level-array sinks",
    labelnames=("sink",))
SINK_BYTES = _registry.counter(
    "sink_bytes_written_total", "Bytes written by io sinks",
    labelnames=("sink",))
STREAM_POINTS = _registry.counter(
    "stream_points_total", "Points ingested by HeatmapStream.update")
STREAM_BATCHES = _registry.counter(
    "stream_batches_total", "Batches ingested by HeatmapStream.update")
STREAM_TIME = _registry.gauge(
    "stream_time_seconds", "Decay clock of the live stream state")
STREAM_TICKS = _registry.counter(
    "stream_ticks_total", "run_stream decay ticks observed by the hook")
DEVICE_BYTES = _registry.gauge(
    "device_bytes_in_use", "Last sampled device memory in use",
    labelnames=("device",))
FEEDER_DEPTH = _registry.gauge(
    "feeder_depth",
    "Device-resident batches queued ahead of the consumer in the "
    "host->device feeder (pipeline/feeder.py; depth > 0 means the next "
    "batch's transfer fully overlapped compute)")
FAULTS_INJECTED = _registry.counter(
    "faults_injected_total", "Faults fired by the injection plane",
    labelnames=("site",))
IO_RETRIES = _registry.counter(
    "io_retries_total", "I/O operations retried by faults.retry",
    labelnames=("site",))
INCIDENTS_TOTAL = _registry.counter(
    "incidents_total", "Incident bundles flushed, by trigger edge",
    labelnames=("trigger",))
RECORDER_DROPPED = _registry.counter(
    "recorder_dropped_total",
    "Flight-recorder ring evictions (spans + events)")
ANOMALIES_TOTAL = _registry.counter(
    "anomalies_total",
    "Anomaly-detector rising edges, by watch spec",
    labelnames=("watch",))
PARTITION_SKEW = _registry.gauge(
    "partition_skew_ratio",
    "Max/mean sampled shard mass of the last Morton partition plan "
    "(parallel/partition; the load-imbalance signal the planner bounds)")
BOUNDARY_TILES = _registry.counter(
    "cascade_boundary_tiles_total",
    "Straddling parent tiles cross-merged by range-sharded cascades "
    "(the entire cross-shard merge volume of the Morton path)")
PROCESS_UPTIME = _registry.gauge(
    "process_uptime_seconds", "Seconds since this process imported obs")
BUILD_INFO = _registry.gauge(
    "heatmap_build_info", "Constant 1; the version label is the payload",
    labelnames=("version",))
_T0 = time.monotonic()


def refresh_process_gauges():
    """Stamp process_uptime_seconds and heatmap_build_info{version}.

    Gauge writes no-op while the registry is disabled, so these are
    refreshed at scrape time (serve /metrics) rather than set once at
    import.
    """
    if not _registry.enabled:
        return
    from heatmap_tpu_torch import __version__

    PROCESS_UPTIME.set(time.monotonic() - _T0)
    BUILD_INFO.set(1, version=__version__)


def telemetry_enabled() -> bool:
    """True when any sink (registry or event log) is live."""
    return _registry.enabled or events._current is not None


def record_stage(stage: str, wall_s: float, items=None, **attrs):
    """Span-close hook: tracer spans feed the registry and event log.

    Called from utils/trace.py on every span exit; must stay cheap when
    telemetry is off (two global reads).
    """
    enabled = _registry.enabled
    log = events._current
    if not enabled and log is None and events._observer is None:
        return
    if enabled:
        STAGE_SECONDS.observe(wall_s, stage=stage)
        if items:
            STAGE_ITEMS.inc(int(items), stage=stage)
    if log is not None or events._observer is not None:
        fields = {k: v for k, v in attrs.items() if v is not None}
        if items:
            fields["items"] = int(items)
        # Through events.emit (not log.emit) so the record is trace-
        # stamped.
        events.emit("stage_end", stage=stage, wall_s=round(wall_s, 6),
                    **fields)


def device_topology(device="cuda") -> dict:
    """Device manifest for run_start: the JAX package's keys, read from
    ``torch.cuda`` for a command on the card and describing the host for
    one on the CPU. One process: index 0 of 1."""
    import torch

    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
        kinds: dict = {}
        for i in range(n):
            name = torch.cuda.get_device_name(i)
            kinds[name] = kinds.get(name, 0) + 1
        platform = "gpu"
    else:
        n, kinds, platform = 1, {"cpu": 1}, "cpu"
    return {"platform": platform, "n_devices": n, "n_local_devices": n,
            "process_index": 0, "process_count": 1, "device_kinds": kinds}


def sample_device_memory() -> list:
    """Sample ``torch.cuda.memory_stats`` of every card this process has
    initialised; emits a device_memory event (an empty samples list
    when the command ran on the CPU, as the JAX package's CPU backend
    gives) and sets the per-card gauge."""
    if not telemetry_enabled():
        return []
    import torch

    samples = []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            samples.append({
                "device": i,
                "platform": "gpu",
                "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "peak_bytes_in_use": int(stats.get(
                    "allocated_bytes.all.peak", 0)),
            })
            DEVICE_BYTES.set(samples[-1]["bytes_in_use"], device=str(i))
    emit("device_memory", samples=samples)
    return samples


def record_fault(site: str, seq: int, key=None, rule: str | None = None):
    """One injected fault fired by the faults plane (seq is the plane's
    own monotonic injection counter, replayable from the event log)."""
    if not telemetry_enabled():
        return
    FAULTS_INJECTED.inc(site=site)
    fields = {}
    if key is not None:
        fields["key"] = str(key)
    if rule is not None:
        fields["rule"] = rule
    emit("fault_injected", site=site, fault_seq=int(seq), **fields)


def record_io_retry(site: str):
    if not telemetry_enabled():
        return
    IO_RETRIES.inc(site=site)


def record_partition_planned(plan, boundary_tiles=None):
    """A Morton partition plan was built (the write plane's first batch).

    Sets partition_skew_ratio to the plan's max/mean sampled shard mass
    and, when the caller passes the per-pyramid boundary-tile count,
    folds it into cascade_boundary_tiles_total.
    """
    if not telemetry_enabled():
        return
    PARTITION_SKEW.set(plan.skew_ratio)
    fields = {}
    if boundary_tiles is not None:
        BOUNDARY_TILES.inc(int(boundary_tiles))
        fields["boundary_tiles"] = int(boundary_tiles)
    emit("partition_planned",
         n_shards=plan.n_shards,
         splits=[int(s) for s in plan.splits],
         sampled_points=plan.sampled_points,
         balance_factor=plan.balance_factor,
         max_shard_mass=max(plan.shard_mass) if plan.shard_mass else 0.0,
         mean_shard_mass=(sum(plan.shard_mass) / len(plan.shard_mass)
                          if plan.shard_mass else 0.0),
         skew_ratio=plan.skew_ratio,
         resplits=plan.resplits,
         degenerate=plan.degenerate,
         fingerprint=plan.fingerprint,
         **fields)


__all__ = [
    "ANOMALIES_TOTAL", "BOUNDARY_TILES", "PARTITION_SKEW", "AnomalyEngine", "BUILD_INFO", "EVENT_SCHEMA",
    "EventLog", "PROCESS_UPTIME", "refresh_process_gauges",
    "FEEDER_DEPTH", "FlightRecorder", "INCIDENTS_TOTAL", "IncidentManager",
    "MetricsRegistry", "RECORDER_DROPPED", "SLOEngine", "SLOSpec",
    "TelemetrySampler", "TimeSeriesStore", "TraceCollector", "WatchSpec",
    "anomaly", "blob_checksum", "build_run_report", "current_span",
    "current_traceparent", "device_topology", "disable_tracing", "emit",
    "enable_metrics", "enable_tracing", "events", "format_run_report",
    "get_collector", "get_event_log", "get_registry", "incident",
    "install_specs", "metrics", "metrics_enabled", "parse_slo_spec",
    "parse_traceparent", "parse_watch_spec", "read_events", "record_fault",
    "record_io_retry", "record_partition_planned", "record_stage", "recorder", "sample_device_memory",
    "set_event_log", "slo", "slo_status", "telemetry_enabled",
    "timeseries", "tracing", "tracing_enabled", "validate_event",
    "write_run_report",
]
