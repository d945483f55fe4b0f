"""Structured run events: append-only JSONL with a checked-in schema.

The port's copy of heatmap_tpu/obs/events.py: the schema and the event
names are the JAX package's word for word, so one validator reads the
logs of both packages.

Every record carries the envelope ``{run_id, seq, ts, event}`` — ``seq``
is monotonic per log (assigned under the writer lock, so concurrent
producer threads cannot collide) and ``ts`` is Unix wall-clock. The
payload fields allowed per event type are pinned in ``EVENT_SCHEMA``;
``validate_event`` rejects unknown fields and missing required ones, so
the log a run emits is exactly the catalog docs/observability.md
documents — an instrumentation site cannot invent an ad-hoc field
without also widening the schema (and its tests).

Emission is a module-level ``emit(event, **fields)`` that no-ops when no
log is installed (``set_event_log``), mirroring the zero-cost stance of
the metrics registry: hot paths pay one global read when events are off.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

# event -> {"required": (...), "optional": (...)}. The envelope fields
# (run_id/seq/ts/event) are implicit on every record.
EVENT_SCHEMA = {
    # Job manifest: resolved config, CLI backend, device topology.
    "run_start": {"required": ("config", "backend", "devices"),
                  "optional": ("argv",)},
    # One per closed tracer span when an event log is installed.
    # trace_id/span_id land automatically when tracing is on (the span
    # that just closed), linking slow aggregates back to span trees.
    "stage_end": {"required": ("stage", "wall_s"),
                  "optional": ("items", "bytes", "backend", "level",
                               "window", "trace_id", "span_id")},
    # Job-level routing decision: how cascade_backend="auto" resolved.
    # ``dispatch`` records how the mesh formulation resolved ("gspmd"
    # one-program NamedSharding vs "shard_map" oracle — pipeline/batch
    # resolved_dispatch), so dispatcher routing stays auditable.
    "backend_resolved": {"required": ("requested", "resolved"),
                         "optional": ("reason", "weighted", "data_parallel",
                                      "n_emissions", "spatial_partition",
                                      "dispatch")},
    # Per-call cascade dispatch record (the audit trail behind
    # backend_resolved: what run_cascade actually executed).
    "cascade_dispatch": {"required": ("backend",),
                         "optional": ("jit", "mesh", "merge", "n_emissions",
                                      "n_slots", "trace_id", "span_id",
                                      "partition", "dispatch")},
    # Morton-range partition plan for a cascade dispatch
    # (parallel/partition.plan_partition): the split codes, the sampled
    # evidence they were chosen from, and the post-resplit balance.
    "partition_planned": {"required": ("n_shards", "splits",
                                       "sampled_points", "balance_factor",
                                       "max_shard_mass", "mean_shard_mass"),
                          "optional": ("skew_ratio", "resplits", "degenerate",
                                       "fingerprint", "boundary_tiles")},
    # torch.cuda.memory_stats() snapshot per card (empty on CPU).
    "device_memory": {"required": ("samples",), "optional": ()},
    # utils/recovery.py shard retry loop.
    "retry": {"required": ("shard", "attempt", "error"), "optional": ()},
    "recovery": {"required": ("shard", "attempts"), "optional": ()},
    # parallel/multihost.py per-host phase heartbeats.
    # traceparent (W3C-style 00-{trace_id}-{span_id}-{flags}) carries
    # the emitting host's ambient trace across process boundaries.
    "heartbeat": {"required": ("process_index", "process_count", "phase"),
                  "optional": ("uptime_s", "traceparent")},
    # utils/trace.py torch_profile failed to start.
    "profiler_unavailable": {"required": ("error",), "optional": ("logdir",)},
    # serve/http.py per-request record (route is the coarse family,
    # e.g. "tiles"; path the concrete URL; cache "hit"/"miss" on tiles).
    "http_request": {"required": ("route", "status"),
                     "optional": ("path", "ms", "bytes", "cache",
                                  "trace_id", "span_id")},
    # serve/store.py full index rebuild (TileStore.reload): every
    # cached tile is invalidated by the generation bump — the
    # heavyweight counterpart to a targeted delta apply.
    "store_reload": {"required": ("old_generation", "generation",
                                  "levels", "seconds"),
                     "optional": ("spec", "layers", "initial")},
    # delta/: one journaled batch applied (sign -1 = retraction).
    # duplicate=True means the content hash was already journaled and
    # the apply was an idempotent no-op (epoch is the existing one).
    "delta_applied": {"required": ("epoch", "points", "sign", "seconds"),
                      "optional": ("content_hash", "artifact", "rows",
                                   "duplicate", "watermark",
                                   "keys_invalidated")},
    # ingest/: one continuous-ingest tick — one micro-batch journaled,
    # applied, and published (delta_applied covers the apply inside;
    # this record adds the loop's view: event-time watermark, queue
    # depth at dequeue, and end-to-end ingest->servable lag).
    "ingest_tick": {"required": ("tick", "points", "seconds"),
                    "optional": ("epoch", "duplicate", "watermark",
                                 "lag_s", "queue_depth", "keys_invalidated",
                                 "compacted", "trace_id", "span_id")},
    # delta/compact.py: fold the live delta stack into a new base.
    "compaction_start": {"required": ("root", "deltas"),
                         "optional": ("base",)},
    "compaction_end": {"required": ("root", "seconds", "status"),
                       "optional": ("base", "levels", "rows",
                                    "pruned_entries", "error", "buckets")},
    # delta/retract.py: one predicate retraction completed — journal
    # scanned, exact signed counter-batches applied per epoch bucket.
    # rows counts retracted source points, batches the counter-batches
    # (one per surviving (bucket, column-signature) group).
    "retraction_applied": {"required": ("root", "rows", "batches"),
                           "optional": ("scanned", "where", "epochs",
                                        "seconds")},
    # serve/http.py: a tile answered from a temporal fold (?as_of=,
    # ?window=, ?decay= — mode names which). Raw request params ride
    # along so traffic replay can rebuild the fold population.
    "temporal_served": {"required": ("layer", "zoom", "mode"),
                        "optional": ("as_of", "window", "decay",
                                     "cache", "ms")},
    # ingest/loop.py: the newest bucket edge advanced past a window
    # boundary — exactly the retiring bucket's tile keys (x their
    # served window variants) were invalidated; everything else stays.
    "bucket_roll": {"required": ("root", "prev_ref", "ref"),
                    "optional": ("retired", "keys_invalidated",
                                 "windows")},
    # faults/: one record per injected fault. ``seq`` is the plane's own
    # monotonic injection counter (not the envelope seq), so a chaos run
    # can be replayed check-for-check from its event log.
    "fault_injected": {"required": ("site", "fault_seq"),
                       "optional": ("key", "rule", "trace_id", "span_id")},
    # serve/http.py degraded-mode transitions (/healthz mirrors the
    # active cause set). Emitted on cause-set edges, not per request.
    "degraded_enter": {"required": ("cause",), "optional": ("detail",)},
    "degraded_exit": {"required": ("cause",), "optional": ("detail",)},
    # serve/degrade.py brownout ladder: one record per rung transition
    # (edge-triggered — never per request). ``cause`` is the hottest
    # objective on the way up, "recovery" on the way down; ``burn`` the
    # max burn fraction that drove the step.
    "degrade_step": {"required": ("rung", "direction", "cause", "burn"),
                     "optional": ("from_rung", "detail")},
    # delta/recover.py startup sweep: one per quarantined artifact
    # (orphan *.tmp, torn/hash-mismatched journal entry, unjournaled
    # delta dir, stale base dir).
    "quarantine": {"required": ("root", "path", "reason"),
                   "optional": ("kind", "detail")},
    # parallel/elastic.py: the elastic coordinator's lineage decisions.
    # shard_orphaned marks a stale host's unfinished shard (one record
    # per shard, paired 1:1 with the shard_reassigned that names the
    # surviving winner); speculative_launch is a duplicate execution of
    # a straggling shard, and speculative_win fires only when the
    # duplicate beats the original (the loser's artifact is quarantined,
    # never merged).
    "shard_orphaned": {"required": ("shard", "host"),
                       "optional": ("reason",)},
    "shard_reassigned": {"required": ("shard", "from_host", "to_host"),
                         "optional": ()},
    "speculative_launch": {"required": ("shard", "host"),
                           "optional": ("runtime_s", "threshold_s")},
    "speculative_win": {"required": ("shard", "winner"),
                        "optional": ("loser", "quarantined")},
    # serve/router.py fleet membership edges: a backend's circuit
    # breaker opening (crash, probe failures, reload failure) emits
    # _down once per episode; the half-open probe that re-closes it
    # emits _up. Edge-triggered like degraded_enter/exit — one pair
    # per outage, not one per failed request.
    "fleet_backend_down": {"required": ("backend", "reason"),
                           "optional": ("detail",)},
    "fleet_backend_up": {"required": ("backend",),
                         "optional": ("detail",)},
    # obs/slo.py: an objective's burn rate crossed 1.0 (rising edge;
    # one record per breach episode, not per evaluation).
    "slo_breach": {"required": ("slo", "burn_rate"),
                   "optional": ("kind", "compliance", "target",
                                "window_s", "detail")},
    # synopsis/build.py: one wavelet-synopsis artifact published for a
    # coarse level (egress, compaction rebuild, or the ingest loop's
    # provisional early-serve build). max_err is the stamped L-inf
    # bound (the ACHIEVED worst cell error across pairs).
    "synopsis_built": {"required": ("zoom", "pairs", "bytes", "max_err"),
                       "optional": ("coefficients", "path", "provisional")},
    # serve/http.py: a tile was answered from a decoded synopsis
    # (?synopsis=1 or layer policy). stale=True marks a provisional
    # early-serve overlay not yet superseded by the exact apply.
    "synopsis_served": {"required": ("layer", "zoom", "max_err"),
                        "optional": ("stale", "source_zoom", "stretched")},
    # analytics/integral.py: one summed-area (integral) artifact
    # published for a coarse level (egress or compaction rebuild).
    "integral_built": {"required": ("zoom", "pairs", "bytes"),
                       "optional": ("path",)},
    # serve/http.py: one /query answered. path names the evaluator:
    # integral (SAT corner lookups / pruned descent), fallback (exact
    # row scan, pre-integral store), synopsis (brownout grid, with the
    # propagated error bound in max_err).
    "query_served": {"required": ("op", "zoom", "path"),
                     "optional": ("layer", "bbox_area", "cells", "k",
                                  "q", "max_err", "ms", "window",
                                  "slots")},
    # obs/anomaly.py: a watched series' EWMA+MAD z-score crossed its
    # threshold (rising edge; one record per breach episode, cleared
    # with hysteresis — never per sampler tick). series is the
    # flattened telemetry key, watch the spec name that matched.
    "anomaly_detected": {"required": ("series", "z"),
                         "optional": ("threshold", "watch", "value",
                                      "detail")},
    # obs/incident.py: one incident bundle flushed (trigger is the
    # edge kind — slo_breach | shed | fault_storm | degraded_enter |
    # anomaly | exception; path the bundle directory; seq the
    # manager's own monotonic bundle counter).
    "incident_flush": {"required": ("trigger", "path"),
                       "optional": ("seq", "detail", "bytes")},
    # tilefs/prewarm.py: one cache pre-warm pass finished (startup or
    # post-/reload). keys counts 2xx replays; planned the full plan
    # length; budget_exhausted marks a time/byte budget cutoff before
    # the plan drained.
    "prewarm_done": {"required": ("keys", "seconds"),
                     "optional": ("bytes", "errors", "planned",
                                  "budget_exhausted", "source")},
    # writeplane/plane.py: one full batch routed across Morton ranges
    # (ranges = sub-applies routed; 0 with duplicate=True means the
    # full-batch ledger deduped it before routing).
    "writeplane_append": {"required": ("points", "ranges"),
                          "optional": ("sign", "duplicate", "seconds",
                                       "content_hash")},
    # writeplane/manifest.py epoch flip: the cross-range visibility
    # point (live_deltas = journal entries not yet compacted, summed
    # over ranges — the reader-side merge width).
    "writeplane_publish": {"required": ("epoch", "ranges"),
                          "optional": ("seconds", "live_deltas")},
    # writeplane/plane.py hot-range re-split: journal handoff + a new
    # range owning [split, hi) — one record per rebalance.
    "writeplane_rebalance": {"required": ("range", "new_range", "split"),
                             "optional": ("reason", "seconds")},
    # Terminal record: exit status + output fingerprint.
    "run_end": {"required": ("status",),
                "optional": ("blobs", "rows", "levels", "checksum",
                             "seconds", "error")},
}

ENVELOPE_FIELDS = ("run_id", "seq", "ts", "event")


def validate_event(rec: dict):
    """Raise ValueError unless ``rec`` is a well-formed event record."""
    if not isinstance(rec, dict):
        raise ValueError(f"event record must be a dict, got {type(rec)}")
    for field in ENVELOPE_FIELDS:
        if field not in rec:
            raise ValueError(f"event record missing envelope field {field!r}")
    if not isinstance(rec["run_id"], str) or not rec["run_id"]:
        raise ValueError("run_id must be a non-empty string")
    if not isinstance(rec["seq"], int) or rec["seq"] < 0:
        raise ValueError("seq must be a non-negative integer")
    if not isinstance(rec["ts"], (int, float)):
        raise ValueError("ts must be numeric")
    event = rec["event"]
    spec = EVENT_SCHEMA.get(event)
    if spec is None:
        raise ValueError(f"unknown event type {event!r}")
    payload = {k for k in rec if k not in ENVELOPE_FIELDS}
    missing = set(spec["required"]) - payload
    if missing:
        raise ValueError(f"{event}: missing required field(s) "
                         f"{sorted(missing)}")
    unknown = payload - set(spec["required"]) - set(spec["optional"])
    if unknown:
        raise ValueError(f"{event}: unknown field(s) {sorted(unknown)}")


class EventLog:
    """Append-only JSONL writer with per-run id and monotonic seq.

    Lines are flushed as written so a crash loses at most the record in
    flight; ``seq`` gaps in a recovered log therefore mean lost tail,
    never reordering.
    """

    def __init__(self, path: str, run_id: str | None = None):
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._seq = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")

    def emit(self, event: str, **fields) -> dict:
        rec = {"run_id": self.run_id, "seq": 0, "ts": time.time(),
               "event": event, **fields}
        with self._lock:
            if self._fh is None:
                raise ValueError(f"event log {self.path} is closed")
            rec["seq"] = self._seq
            validate_event(rec)
            self._seq += 1
            self._fh.write(json.dumps(rec, sort_keys=False,
                                      default=str) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_current: EventLog | None = None

# Integration hooks, both None unless their owner installed them (one
# global read each on the emit path, keeping the zero-cost stance):
# - _trace_ids: set by obs.tracing.enable_tracing; returns the ambient
#   (trace_id, span_id) so _TRACE_STAMPED events link to span trees.
# - _observer: set by obs.slo.set_engine; sees every emitted record so
#   the SLO window fills without re-reading the log file.
# - _recorder: set by obs.recorder when a flight recorder or incident
#   manager is installed; sees every record (ring tail + trigger
#   detection), even without a log or observer.
_trace_ids = None
_observer = None
_recorder = None

# Events that get the ambient trace identity stamped automatically
# (explicit trace_id in fields always wins, e.g. serve passes the
# request root's ids after the span has closed).
_TRACE_STAMPED = frozenset(
    {"stage_end", "http_request", "fault_injected", "cascade_dispatch",
     "ingest_tick"})


def set_event_log(log: EventLog | None):
    """Install (or clear, with None) the process-wide event log."""
    global _current
    _current = log


def get_event_log() -> EventLog | None:
    return _current


def emit(event: str, **fields) -> dict | None:
    """Emit to the installed log; no-op (returns None) when none is set.

    The observer hook fires even without a log (on a synthetic,
    unjournaled record), so ``serve --slo`` fills its compliance
    window without requiring ``--events``.
    """
    log = _current
    observer = _observer
    recorder = _recorder
    if log is None and observer is None and recorder is None:
        return None
    ids_fn = _trace_ids
    if (ids_fn is not None and event in _TRACE_STAMPED
            and "trace_id" not in fields):
        ids = ids_fn()
        if ids is not None:
            fields["trace_id"], fields["span_id"] = ids
    rec = (log.emit(event, **fields) if log is not None
           else {"run_id": "-", "seq": -1, "ts": time.time(),
                 "event": event, **fields})
    if observer is not None:
        observer(rec)
    if recorder is not None:
        recorder(rec)
    return rec if log is not None else None


def read_events(path: str) -> list:
    """Parse a JSONL event log back into records (no validation)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
