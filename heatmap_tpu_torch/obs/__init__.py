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
every ``/metrics`` scrape), the partition planner's recorder
(``record_partition_planned``) and the multihost recorders (heartbeats,
shard retries, elastic shards, speculative launches) are here too. A
process's identity (``process_index``/``process_count``) is its rank in
the ``torch.distributed`` group once a multihost job has joined one
(devices.py), else 0 of 1.
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
SHARD_RETRIES = _registry.counter(
    "shard_retries_total", "Shard attempts that raised and were retried")
HOST_PHASE_SECONDS = _registry.gauge(
    "multihost_phase_uptime_seconds",
    "Per-host uptime at each job phase (straggler gap = max-min)",
    labelnames=("phase", "process"))
HOST_LAST_HEARTBEAT = _registry.gauge(
    "multihost_last_heartbeat_ts", "Unix time of each host's last heartbeat",
    labelnames=("process",))
ELASTIC_REASSIGNMENTS = _registry.counter(
    "elastic_reassignments_total",
    "Orphaned shards reassigned to surviving hosts (parallel/elastic)")
SPECULATIVE_LAUNCHES = _registry.counter(
    "speculative_launches_total",
    "Speculative duplicate shard executions by race outcome",
    labelnames=("outcome",))  # outcome = win | lose
DISPATCH_OVERHEAD = _registry.histogram(
    "dispatch_overhead_seconds",
    "Host-side share of one cascade dispatch (routing, padding, plan, "
    "argument prep — everything before the compiled program runs; the "
    "overhead the gspmd one-program dispatch removes)",
    labelnames=("dispatch",))
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


class DispatchTimer:
    """Host/device wall-time split for ONE cascade dispatch.

    Splits the cascade's ``stage_duration_seconds`` attribution into
    ``cascade.dispatch.host`` (routing, padding, partition planning,
    argument prep: everything before the cascade's kernels are enqueued)
    and ``cascade.dispatch.device`` (enqueued to outputs on the host),
    and feeds ``dispatch_overhead_seconds{dispatch}`` with the host
    share. Construct at the start of the host phase, call
    :meth:`dispatched` once the cascade's kernels are enqueued and
    :meth:`finished` once its outputs are ready (the caller synchronises
    the card in between, and only while ``enabled``). Everything no-ops
    when telemetry is off, so the production path pays two global reads.
    """

    __slots__ = ("dispatch", "enabled", "_t0", "_t1")

    def __init__(self, dispatch: str):
        self.dispatch = dispatch
        self.enabled = telemetry_enabled()
        self._t0 = time.perf_counter() if self.enabled else 0.0
        self._t1 = None

    def dispatched(self) -> None:
        """Host phase over: the card owns the clock now."""
        if self.enabled:
            self._t1 = time.perf_counter()

    def finished(self, items=None):
        """Outputs ready; record both phases. Returns (host_s,
        device_s) when telemetry is on, else None."""
        if not self.enabled or self._t1 is None:
            return None
        t2 = time.perf_counter()
        host_s, device_s = self._t1 - self._t0, t2 - self._t1
        record_stage("cascade.dispatch.host", host_s, items)
        record_stage("cascade.dispatch.device", device_s, items)
        if _registry.enabled:
            DISPATCH_OVERHEAD.observe(host_s, dispatch=self.dispatch)
        return host_s, device_s


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
    one on the CPU; the process identity is the job's rank."""
    import torch

    from heatmap_tpu_torch.devices import process_count, process_index

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
            "process_index": process_index(),
            "process_count": process_count(), "device_kinds": kinds}


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


def heartbeat(phase: str, process: int | None = None):
    """Per-host liveness mark for multihost phases.

    The ``multihost.heartbeat`` fault site models a *lost* heartbeat: an
    injected fault suppresses the gauge and event update without failing
    the caller, so the staleness monitors (``heartbeat_ages`` /
    ``check_heartbeats``) see exactly what a dead host would produce.
    ``process`` overrides the host identity (default: this process's
    rank); the elastic runner's simulated hosts beat with their own ids,
    and the fault key is then ``p<process>``.
    """
    if not telemetry_enabled():
        return
    from heatmap_tpu_torch import faults
    from heatmap_tpu_torch.devices import process_count, process_index

    try:
        faults.check("multihost.heartbeat",
                     key=phase if process is None else f"p{process}")
    except faults.InjectedFault:
        return  # heartbeat lost in transit; liveness gauges go stale
    pi = process_index() if process is None else int(process)
    uptime = time.monotonic() - _T0
    HOST_PHASE_SECONDS.set(uptime, phase=phase, process=str(pi))
    HOST_LAST_HEARTBEAT.set(time.time(), process=str(pi))
    fields = {}
    tp = tracing.current_traceparent()
    if tp is not None:
        fields["traceparent"] = tp
    emit("heartbeat", process_index=pi, process_count=process_count(),
         phase=phase, uptime_s=round(uptime, 3), **fields)


def heartbeat_ages(now: float | None = None) -> dict:
    """Seconds since each process's last heartbeat, ``{process: age_s}``,
    from the ``multihost_last_heartbeat_ts`` gauge; empty while the
    registry is off. ``now`` overrides the wall clock."""
    if not _registry.enabled:
        return {}
    if now is None:
        now = time.time()
    return {key[0]: now - ts
            for key, ts in HOST_LAST_HEARTBEAT.samples().items()}


def record_retry(shard: int, attempt: int, error: BaseException):
    if not telemetry_enabled():
        return
    SHARD_RETRIES.inc()
    emit("retry", shard=int(shard), attempt=int(attempt),
         error=repr(error))


def record_recovery(shard: int, attempts: int):
    if not telemetry_enabled():
        return
    emit("recovery", shard=int(shard), attempts=int(attempts))


def record_shard_orphaned(shard, host, reason: str | None = None):
    """A stale host's unfinished shard was marked orphaned
    (parallel/elastic.py failover)."""
    if not telemetry_enabled():
        return
    fields = {"reason": reason} if reason else {}
    emit("shard_orphaned", shard=str(shard), host=str(host), **fields)


def record_shard_reassigned(shard, from_host, to_host):
    """An orphaned shard was handed to a surviving host; paired 1:1 with
    record_shard_orphaned and counted in elastic_reassignments_total."""
    if not telemetry_enabled():
        return
    ELASTIC_REASSIGNMENTS.inc()
    emit("shard_reassigned", shard=str(shard), from_host=str(from_host),
         to_host=str(to_host))


def record_speculative_launch(shard, host, runtime_s=None,
                              threshold_s=None):
    """A duplicate execution of a straggling shard was launched on an
    idle host (first completion wins)."""
    if not telemetry_enabled():
        return
    fields = {}
    if runtime_s is not None:
        fields["runtime_s"] = round(float(runtime_s), 3)
    if threshold_s is not None:
        fields["threshold_s"] = round(float(threshold_s), 3)
    emit("speculative_launch", shard=str(shard), host=str(host), **fields)


def record_speculative_result(shard, winner, loser=None, won: bool = False,
                              quarantined: str | None = None):
    """Resolve one speculative race: increments
    speculative_launches_total{outcome} and, when the duplicate won,
    emits speculative_win naming the quarantined loser artifact."""
    if not telemetry_enabled():
        return
    SPECULATIVE_LAUNCHES.inc(outcome="win" if won else "lose")
    if won:
        fields = {}
        if loser is not None:
            fields["loser"] = str(loser)
        if quarantined is not None:
            fields["quarantined"] = str(quarantined)
        emit("speculative_win", shard=str(shard), winner=str(winner),
             **fields)


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
    "DISPATCH_OVERHEAD", "DispatchTimer",
    "ANOMALIES_TOTAL", "BOUNDARY_TILES", "PARTITION_SKEW", "AnomalyEngine", "BUILD_INFO", "EVENT_SCHEMA",
    "ELASTIC_REASSIGNMENTS", "HOST_LAST_HEARTBEAT", "HOST_PHASE_SECONDS",
    "SHARD_RETRIES", "SPECULATIVE_LAUNCHES", "heartbeat", "heartbeat_ages",
    "record_recovery", "record_retry", "record_shard_orphaned",
    "record_shard_reassigned", "record_speculative_launch",
    "record_speculative_result",
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
