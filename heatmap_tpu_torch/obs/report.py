"""Fold tracer + metrics registry + event log into one run report.

The port's copy of heatmap_tpu/obs/report.py. ``blob_checksum`` is the
JAX package's, so two runs of either package with the same blobs
carry the same checksum.

``build_run_report`` produces the ``run_report.json`` artifact: the run
manifest (from ``run_start``/``run_end``), per-stage wall-clock with
backend attribution (tracer spans + ``backend_resolved`` events), a full
metrics snapshot, the last device-memory sample, and any warnings (e.g.
the profiler being unavailable). ``format_run_report`` renders the
human-readable table that supersedes the ``--profile``-only stderr dump.

Timings here are HOST spans: CUDA work is asynchronous, so a stage's
wall-clock measures until the host waits on a result, not device
occupancy (see utils/trace.py and docs/observability.md).
"""

from __future__ import annotations

import json
import os
import zlib

REPORT_SCHEMA = "heatmap-tpu.run_report.v1"


def blob_checksum(blobs: dict) -> str:
    """Order-independent crc32 fingerprint of a blob dict, for run_end:
    two runs produced identical output iff the checksums match."""
    crc = 0
    for key in sorted(blobs):
        value = blobs[key]
        if not isinstance(value, str):
            value = json.dumps(value, sort_keys=True, default=str)
        crc = zlib.crc32(f"{key}\x00{value}\x01".encode(), crc)
    return f"crc32:{crc:08x}"


def build_run_report(tracer=None, registry=None,
                     events_path: str | None = None) -> dict:
    """Assemble the report dict from whichever sources are available.

    When tracing is live its collector summary folds in as ``trace``;
    when an SLO engine is installed its status folds in as ``slo``
    (evaluated over whatever the engine has observed/ingested).
    """
    report: dict = {"schema": REPORT_SCHEMA}
    warnings: list = []

    if tracer is not None:
        stages = {}
        for name, rec in sorted(tracer.report().items()):
            stages[name] = {
                "count": rec["count"],
                "total_s": round(rec["total_s"], 6),
                "mean_s": round(rec["mean_s"], 6),
                "max_s": round(rec["max_s"], 6),
                "items": rec["items"],
                "items_per_s": (round(rec["items_per_s"])
                                if rec["items_per_s"] else None),
            }
        report["stages"] = stages
        pw = getattr(tracer, "profiler_warning", None)
        if pw:
            warnings.append(pw)

    if registry is not None:
        report["metrics"] = registry.snapshot()

    if events_path and os.path.exists(events_path):
        from heatmap_tpu_torch.obs.events import read_events

        records = read_events(events_path)
        by_type: dict = {}
        for rec in records:
            by_type[rec.get("event", "?")] = (
                by_type.get(rec.get("event", "?"), 0) + 1)
        events_summary = {"path": events_path, "count": len(records),
                          "by_type": by_type}
        report["events"] = events_summary

        run: dict = {}
        backends = []
        last_mem = None
        for rec in records:
            ev = rec.get("event")
            if ev == "run_start":
                run["run_id"] = rec.get("run_id")
                run["started_ts"] = rec.get("ts")
                run["backend"] = rec.get("backend")
                run["devices"] = rec.get("devices")
                run["config"] = rec.get("config")
            elif ev == "run_end":
                for k in ("status", "blobs", "rows", "levels", "checksum",
                          "seconds", "error"):
                    if k in rec:
                        run[k] = rec[k]
            elif ev == "backend_resolved":
                backends.append({k: rec[k] for k in
                                 ("requested", "resolved", "reason",
                                  "weighted", "data_parallel", "n_emissions")
                                 if k in rec})
            elif ev == "device_memory":
                last_mem = rec.get("samples")
            elif ev == "profiler_unavailable":
                warnings.append(f"profiler unavailable: {rec.get('error')}")
        if run:
            report["run"] = run
        if backends:
            report["backends"] = backends
        if last_mem is not None:
            report["device_memory"] = last_mem

    from heatmap_tpu_torch.obs import slo, tracing

    collector = tracing.get_collector()
    if collector is not None:
        report["trace"] = collector.summary()
    slo_state = slo.slo_status()
    if slo_state is not None:
        report["slo"] = slo_state

    if warnings:
        report["warnings"] = warnings
    return report


def write_run_report(path: str, report: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, default=str)
        f.write("\n")
    os.replace(tmp, path)


def format_run_report(report: dict) -> str:
    """Human-readable rendering: run summary, stage table, warnings."""
    lines = ["run report"]
    run = report.get("run") or {}
    if run:
        head = [f"run_id={run.get('run_id', '?')}",
                f"status={run.get('status', '?')}"]
        if run.get("seconds") is not None:
            head.append(f"seconds={run['seconds']}")
        if run.get("blobs") is not None:
            head.append(f"blobs={run['blobs']}")
        if run.get("rows") is not None:
            head.append(f"rows={run['rows']}")
        if run.get("checksum"):
            head.append(f"checksum={run['checksum']}")
        lines.append("  " + "  ".join(head))
    for res in report.get("backends", ()):
        lines.append(
            "  cascade backend: "
            f"{res.get('requested', '?')} -> {res.get('resolved', '?')}"
            + (f" ({res['reason']})" if res.get("reason") else ""))

    stages = report.get("stages") or {}
    if stages:
        lines.append(f"{'stage':<28}{'count':>7}{'total_s':>10}"
                     f"{'mean_s':>10}{'max_s':>10}  items/s")
        for name, rec in sorted(stages.items()):
            ips = (f"{rec['items_per_s']:,}" if rec.get("items_per_s")
                   else "-")
            lines.append(f"{name:<28}{rec['count']:>7}"
                         f"{rec['total_s']:>10.3f}{rec['mean_s']:>10.4f}"
                         f"{rec['max_s']:>10.4f}  {ips}")
    else:
        lines.append("  (no stage spans recorded)")

    trace = report.get("trace")
    if trace:
        lines.append(f"  traces: {trace.get('n_traces', 0)} "
                     f"({trace.get('n_spans', 0)} spans)")
        for root in trace.get("roots", ()):
            lines.append(f"    {root['name']:<26}{root['wall_s']:>10.3f}s"
                         f"  spans={root['n_spans']}")
    slo_state = report.get("slo")
    if slo_state:
        for obj in slo_state.get("objectives", ()):
            flag = "BREACH" if obj.get("breaching") else "ok"
            lines.append(
                f"  slo {obj['name']:<22}{flag:>7}  "
                f"compliance={obj.get('compliance')} "
                f"burn={obj.get('burn_rate')}x")

    mem = report.get("device_memory")
    if mem:
        for s in mem:
            lines.append(
                f"  device {s.get('device')}: "
                f"{s.get('bytes_in_use', 0):,} bytes in use "
                f"(peak {s.get('peak_bytes_in_use', 0):,})")
    for w in report.get("warnings", ()):
        lines.append(f"  WARNING: {w}")
    return "\n".join(lines)
