"""Elastic multihost execution: shard lineage, failover, speculation.

The port's copy of heatmap_tpu/parallel/elastic.py. The simulated hosts
are threads over one process's devices; the executor's lock serializes
their cascades, so no two threads launch (or build) a kernel at once,
and the kernel builds themselves load under ``_build``'s lock. Real
processes are the members of the job's ``torch.distributed`` group
(multihost.initialize); no step uses a collective.

The reference pipeline delegated all fault tolerance to Spark, whose
defining robustness feature is lineage-based task re-execution on
worker loss (PAPERS.md: arxiv 1811.04875 attributes Spark's resilience
edge over MPI to exactly this). `run_job_multihost` *detects* a dead
host (`check_heartbeats` -> typed StragglerTimeout) but the whole job
then dies. This module turns host failure from fatal into recoverable,
exploiting the same linearity the delta engine pinned:
pyramid(union) = merge of per-shard pyramids, so recovery is *exact* —
a re-executed shard contributes identical bytes.

Three pillars:

1. **Shard-lineage manifest** (:class:`ShardLineage`). The job is cut
   into contiguous batch-range shards; each is content-hashed over its
   input slice identity + the byte-affecting config fingerprint
   (``delta.compact.config_fingerprint``, the same dedup idiom as the
   delta journal's ``batch_content_hash``). A completed shard persists
   its partial pyramid through the existing atomic ``publish_dir``
   path, so finished work survives a crash and re-runs are
   exactly-once by hash: a second executor of the same shard either
   skips (manifest hit) or loses the publish race and is quarantined.

2. **Failover re-execution**. On :class:`StragglerTimeout` the
   coordinator — instead of raising — marks the stale host's
   unfinished shards orphaned and reassigns them round-robin to the
   surviving hosts (``on_straggler="reassign"`` on
   ``run_job_multihost``; the default ``"raise"`` preserves the
   historical behavior). Orphan re-execution runs under the
   ``elastic.reassign`` fault site/policy. The final merge draws each
   shard's pyramid from exactly one winner, so the output is
   byte-identical to an unfailed run.

3. **Speculative straggler duplication**. When a running shard's
   elapsed time exceeds ``speculative_factor`` x a quantile of
   completed-shard durations (the durations also feed the
   ``stage_duration_seconds{stage="elastic.shard"}`` histogram), an
   idle host launches a duplicate. First completion wins the atomic
   publish; the loser's artifact is quarantined, never merged.

Two runners share the machinery:

- **Simulated hosts** (one process): ``n_hosts``
  worker threads over one process's devices — the testable path
  (tools/chaos_soak.py ``host_loss`` phase). Each simulated host
  heartbeats with its own identity (``obs.heartbeat(phase,
  process=h)``), so a chaos rule ``multihost.heartbeat@p2=999`` kills
  exactly one host's liveness while the monitor thread watches
  ``check_heartbeats``.
- **Real processes** (a process group of several): every process runs
  its own shards against the shared ``lineage_dir``, then polls the
  manifest. Because per-process registries cannot see each other's
  heartbeats, failure detection is *progress-based*: if no new shard
  completes within the deadline, survivors claim the missing shards in
  deterministic order — publish atomicity dedups double-claims. No
  step uses a collective, so a dead host cannot hang the egress;
  process 0 merges from the manifest and writes the sink.

Quantified in docs/robustness.md (failure-mode matrix) and exercised
by tools/chaos_soak.py.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import itertools
import json
import os
import shutil
import threading
import time
from collections import deque

import numpy as np

from heatmap_tpu_torch import devices as _devices
from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.io.merge import merge_level_dirs
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.utils.checkpoint import publish_dir

SHARDS_DIRNAME = "shards"
QUARANTINE_DIRNAME = "quarantine"

#: Worker/monitor poll interval — every wait in this module is an
#: Event/join timeout (the ingest/loop.py idiom), never time.sleep.
_POLL_S = 0.02
#: Minimum completed-shard sample before speculation can trigger.
_MIN_SPECULATION_SAMPLES = 3


# ---------------------------------------------------------------------------
# Shard plan + lineage fingerprints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkShard:
    """One unit of elastic work: the contiguous batch range [lo, hi)
    of the job's source at the job's pinned batch size.

    Under ``partition="morton"`` the shard additionally owns the
    contiguous detail-zoom Morton code range ``[code_lo, code_hi)``
    (from a parallel.partition plan): every shard reads the same batch
    range but keeps only its own tile range, so failover re-execution
    touches exactly the dead host's tile ranges instead of a
    batch-range slice of the whole map. ``None`` (default) keeps the
    historical batch-range semantics."""

    index: int
    lo: int
    hi: int
    fingerprint: str
    code_lo: int | None = None
    code_hi: int | None = None

    @property
    def dirname(self) -> str:
        # Readable + hash-keyed: the hash is the dedup identity, the
        # index prefix keeps the manifest listable in plan order.
        return f"shard-{self.index:05d}-{self.fingerprint[:16]}"


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def job_fingerprint(source, config, batch_size: int, n_total: int) -> str:
    """Deterministic identity of the whole job: source descriptor +
    batch granularity + the byte-affecting config fingerprint. Sources
    iterate deterministically (pinned in io/sources.py), so slice
    identity under this fingerprint IS content identity — which is what
    lets a host check shard completion without re-reading the input."""
    from heatmap_tpu_torch.delta.compact import config_fingerprint

    if dataclasses.is_dataclass(source) and not isinstance(source, type):
        src = {"class": type(source).__name__}
        for f in dataclasses.fields(source):
            src[f.name] = _jsonable(getattr(source, f.name))
    else:
        src = {"class": type(source).__name__, "repr": repr(source)}
    payload = json.dumps(
        {"source": src, "batch_size": int(batch_size),
         "n_total": int(n_total), "config": config_fingerprint(config)},
        sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()


def shard_fingerprint(job_fp: str, lo: int, hi: int,
                      code_lo=None, code_hi=None) -> str:
    ident = f"{job_fp}:{int(lo)}:{int(hi)}"
    if code_lo is not None:
        # Distinct namespace from batch-range shards: the same batch
        # slice filtered to a tile range is different content.
        ident += f":morton:{int(code_lo)}:{int(code_hi)}"
    return hashlib.sha256(ident.encode()).hexdigest()


def plan_shards(n_batches: int, n_shards: int, job_fp: str, *,
                code_ranges=None) -> list:
    """Contiguous balanced split of the batch index space into
    ``n_shards`` WorkShards (the process_shard_bounds shape).

    ``code_ranges`` switches to ``partition="morton"`` shards: one
    WorkShard per ``[code_lo, code_hi)`` detail-code range (from
    ``parallel.partition.PartitionPlan.code_ranges()``), each spanning
    the FULL batch range — ownership is spatial, not positional, so a
    re-executed shard reproduces exactly one tile range. Empty ranges
    (``code_lo == code_hi``) are planned too: they publish empty
    partials, keeping shard count == plan shard count so failover
    bookkeeping stays positional."""
    if code_ranges is not None:
        n_batches = max(0, int(n_batches))
        return [
            WorkShard(index=i, lo=0, hi=n_batches,
                      fingerprint=shard_fingerprint(
                          job_fp, 0, n_batches, code_lo=clo, code_hi=chi),
                      code_lo=int(clo), code_hi=int(chi))
            for i, (clo, chi) in enumerate(code_ranges)
        ]
    n_shards = max(1, min(int(n_shards), max(1, int(n_batches))))
    base, rem = divmod(max(0, int(n_batches)), n_shards)
    out, lo = [], 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < rem else 0)
        out.append(WorkShard(index=i, lo=lo, hi=hi,
                             fingerprint=shard_fingerprint(job_fp, lo, hi)))
        lo = hi
    return out


def columns_digest(data: dict) -> str:
    """Content digest of ingested columns — stored in each shard's
    manifest meta as the integrity binding between the slice-identity
    fingerprint and the actual bytes that produced the artifact (the
    journal's batch_content_hash idiom)."""
    h = hashlib.sha256()
    for k in sorted(data):
        v = np.asarray(data[k])
        h.update(k.encode())
        if v.dtype == object:
            h.update("\x00".join(str(x) for x in v.ravel()).encode())
        else:
            h.update(str(v.dtype).encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return "sha256:" + h.hexdigest()


# ---------------------------------------------------------------------------
# The on-disk lineage manifest
# ---------------------------------------------------------------------------


class ShardLineage:
    """Durable manifest of completed shards under ``root``.

    A shard is complete iff ``<root>/shards/<dirname>`` exists — and it
    can only exist via ``publish_dir`` (stage to a per-host tmp, fsync,
    atomic rename), so existence implies a whole artifact. Exactly-once
    follows from rename atomicity: of N racing executors of one shard,
    exactly one rename lands; losers are moved into
    ``<root>/quarantine/`` (inspectable, never merged — the
    delta/recover.py quarantine discipline)."""

    def __init__(self, root: str):
        self.root = root
        self.shards_dir = os.path.join(root, SHARDS_DIRNAME)
        self.quarantine_dir = os.path.join(root, QUARANTINE_DIRNAME)
        os.makedirs(self.shards_dir, exist_ok=True)

    def shard_path(self, shard: WorkShard) -> str:
        return os.path.join(self.shards_dir, shard.dirname)

    def is_complete(self, shard: WorkShard) -> bool:
        return os.path.isdir(self.shard_path(shard))

    def completed_count(self, shards) -> int:
        return sum(1 for s in shards if self.is_complete(s))

    def publish(self, shard: WorkShard, host, levels, meta: dict):
        """Stage + atomically publish one shard artifact.

        Returns ``(won, quarantined_path)``: ``won=False`` means
        another executor's artifact landed first — ours (if staged) is
        quarantined and must not be merged."""
        final = self.shard_path(shard)
        if os.path.isdir(final):
            return False, None
        tmp = final + f".tmp-h{host}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)  # this host's own crashed staging
        rows = LevelArraysSink(tmp).write_levels(levels)
        meta = dict(meta, rows=int(rows), host=str(host),
                    fingerprint=shard.fingerprint, index=shard.index,
                    lo=shard.lo, hi=shard.hi)
        with open(os.path.join(tmp, "shard.json"), "w") as f:
            json.dump(meta, f, sort_keys=True)
        try:
            publish_dir(tmp, final)
        except FileExistsError:
            return False, self._quarantine_loser(tmp, shard)
        except OSError as e:
            # The rename itself can lose the race: POSIX rename onto a
            # non-empty directory is ENOTEMPTY (EEXIST on some
            # platforms). Anything else is a real I/O error.
            if e.errno not in (errno.EEXIST, errno.ENOTEMPTY):
                raise
            return False, self._quarantine_loser(tmp, shard)
        return True, None

    def _quarantine_loser(self, tmp: str, shard: WorkShard) -> str:
        os.makedirs(self.quarantine_dir, exist_ok=True)
        base = shard.dirname + "-loser"
        dest = os.path.join(self.quarantine_dir, base)
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = os.path.join(self.quarantine_dir, f"{base}.{n}")
        shutil.move(tmp, dest)
        return dest

    def merge(self, shards) -> list:
        """Final merge: each shard's pyramid from exactly one winner
        (the manifest entry), in plan order — deterministic output
        regardless of which host produced which artifact."""
        dirs, missing = [], []
        for s in shards:
            p = self.shard_path(s)
            (dirs if os.path.isdir(p) else missing).append(p)
        if missing:
            raise RuntimeError(
                f"elastic merge: {len(missing)} shard artifact(s) "
                f"missing from {self.shards_dir} (first: {missing[0]})")
        return merge_level_dirs(dirs)


# ---------------------------------------------------------------------------
# The in-memory coordinator (simulated-host runner)
# ---------------------------------------------------------------------------


class ElasticCoordinator:
    """Thread-safe shard scheduler for the simulated-host runner.

    Owns assignment (initial round-robin by shard index), orphan
    reassignment on host death, and the speculative-duplication
    decision. All clock values come in from the caller so tests can
    drive it with a fake clock."""

    PENDING, RUNNING, DONE = "pending", "running", "done"

    def __init__(self, shards, hosts, *, speculative_quantile=None,
                 speculative_factor: float = 2.0,
                 min_samples: int = _MIN_SPECULATION_SAMPLES):
        self._lock = threading.Lock()
        self.shards = list(shards)
        self.hosts = list(hosts)
        self.speculative_quantile = speculative_quantile
        self.speculative_factor = float(speculative_factor)
        self.min_samples = int(min_samples)
        self.status = {s.index: self.PENDING for s in self.shards}
        self.owner = {s.index: self.hosts[s.index % len(self.hosts)]
                      for s in self.shards}
        self.queues = {h: deque() for h in self.hosts}
        for s in self.shards:
            self.queues[self.owner[s.index]].append((s, "own"))
        self.starts = {}  # (shard index, host) -> start clock
        self.durations = []  # first-completion wall times
        self.dead = set()
        self.speculated = set()
        self.reassigned = 0

    # -- scheduling --------------------------------------------------------

    def next_work(self, host, now: float):
        """Claim the next unit for ``host``: its own queue first, then
        a speculative duplicate of a straggling shard. Returns
        ``(shard, mode)`` with mode in {"own", "orphan", "speculate"},
        or None when there is nothing for this host right now."""
        launch = None
        with self._lock:
            if host in self.dead:
                return None
            q = self.queues[host]
            while q:
                shard, mode = q.popleft()
                if self.status[shard.index] == self.DONE:
                    continue
                self.status[shard.index] = self.RUNNING
                self.starts[(shard.index, host)] = now
                return shard, mode
            cand = self._speculation_candidate(host, now)
            if cand is None:
                return None
            shard, elapsed, thr = cand
            self.speculated.add(shard.index)
            self.status[shard.index] = self.RUNNING
            self.starts[(shard.index, host)] = now
            launch = (shard, elapsed, thr)
        shard, elapsed, thr = launch
        obs.record_speculative_launch(shard.index, host,
                                      runtime_s=elapsed, threshold_s=thr)
        return shard, "speculate"

    def _speculation_candidate(self, host, now):
        # lock held
        thr = self.speculation_threshold()
        if thr is None:
            return None
        best = None
        for s in self.shards:
            i = s.index
            if (self.status[i] != self.RUNNING or i in self.speculated):
                continue
            runners = [h for (j, h) in self.starts if j == i]
            if host in runners:
                continue
            started = min(self.starts[(i, h)] for h in runners)
            elapsed = now - started
            if elapsed > thr and (best is None or elapsed > best[1]):
                best = (s, elapsed)
        return None if best is None else (best[0], best[1], thr)

    def speculation_threshold(self):
        """``factor`` x the q-quantile of completed-shard durations, or
        None while speculation is off / under-sampled. Durations also
        land in stage_duration_seconds{stage="elastic.shard"} via
        mark_done, so dashboards see the same distribution."""
        if self.speculative_quantile is None:
            return None
        dur = sorted(self.durations)
        if len(dur) < self.min_samples:
            return None
        q = min(max(float(self.speculative_quantile), 0.0), 1.0)
        return self.speculative_factor * dur[int(q * (len(dur) - 1))]

    def mark_done(self, shard: WorkShard, host, now: float) -> bool:
        """Record one executor's completion; True iff it was the shard's
        first (the winner whose duration feeds the histogram)."""
        with self._lock:
            start = self.starts.get((shard.index, host))
            first = self.status[shard.index] != self.DONE
            self.status[shard.index] = self.DONE
            if first and start is not None:
                self.durations.append(now - start)
        if first and start is not None:
            obs.record_stage("elastic.shard", now - start)
        return first

    def all_done(self) -> bool:
        with self._lock:
            return all(v == self.DONE for v in self.status.values())

    def done_count(self) -> int:
        with self._lock:
            return sum(1 for v in self.status.values() if v == self.DONE)

    # -- failover ----------------------------------------------------------

    def orphan_stale(self, stale_hosts, reason: str = "heartbeat") -> int:
        """Mark ``stale_hosts`` dead and reassign their unfinished
        shards round-robin to the surviving hosts. Idempotent for
        already-dead hosts; returns the number of reassignments."""
        stale = {str(h) for h in stale_hosts}
        events = []
        with self._lock:
            newly = [h for h in self.hosts
                     if str(h) in stale and h not in self.dead]
            if not newly:
                return 0
            self.dead.update(newly)
            survivors = sorted(h for h in self.hosts if h not in self.dead)
            if not survivors:
                raise RuntimeError(
                    "elastic failover: no surviving hosts to reassign to")
            orphans = []
            for h in newly:
                for shard, _mode in self.queues[h]:
                    if self.status[shard.index] != self.DONE:
                        orphans.append((shard, h))
                self.queues[h].clear()
                # Shards RUNNING on the dead host with no live
                # co-runner (no speculative duplicate) are orphans too.
                for s in self.shards:
                    i = s.index
                    if self.status[i] != self.RUNNING:
                        continue
                    runners = {hh for (j, hh) in self.starts if j == i}
                    if h in runners and not (runners - self.dead):
                        orphans.append((s, h))
            seen = set()
            for k, (shard, from_host) in enumerate(orphans):
                if shard.index in seen:
                    continue
                seen.add(shard.index)
                to_host = survivors[k % len(survivors)]
                self.owner[shard.index] = to_host
                self.status[shard.index] = self.PENDING
                self.queues[to_host].append((shard, "orphan"))
                self.reassigned += 1
                events.append((shard.index, from_host, to_host))
        for idx, from_host, to_host in events:
            obs.record_shard_orphaned(idx, from_host, reason=reason)
            obs.record_shard_reassigned(idx, from_host, to_host)
        return len(events)


# ---------------------------------------------------------------------------
# Shard execution (shared by both runners)
# ---------------------------------------------------------------------------


def _project_detail_codes(lat, lon, detail_zoom: int):
    """Host-side float64 projection to detail-zoom Morton codes + validity
    (``project_detail_codes(prefer_device=False)``)."""
    from heatmap_tpu_torch.pipeline.batch import project_detail_codes

    return project_detail_codes(lat, lon, detail_zoom, prefer_device=False)


def _make_executor(source, config, batch_size: int, exec_lock,
                   device="cuda"):
    """shard -> (levels, meta): read the shard's batch slice, run the
    ordinary cascade on it on ``device``, capture the partial pyramid.
    The lock serializes the device work of the simulated-host threads.

    Morton shards (``shard.code_lo is not None``) read their batch
    slice and keep only rows whose projected detail code falls in
    ``[code_lo, code_hi)``. Rows with invalid projection belong to NO
    range — they contribute nothing in any path (``valid=False`` lanes
    in the ordinary cascade), so dropping them keeps the merged result
    byte-identical to batch-range sharding."""
    from heatmap_tpu_torch.parallel.multihost import _CaptureLevels
    from heatmap_tpu_torch.pipeline.batch import _run_loaded, ingest_columns

    def execute(shard: WorkShard):
        batches = itertools.islice(source.batches(batch_size),
                                   shard.lo, shard.hi)
        with exec_lock:
            data = ingest_columns(batches, config)
            if data is not None and shard.code_lo is not None:
                codes, valid = _project_detail_codes(
                    np.asarray(data["latitude"], np.float64),
                    np.asarray(data["longitude"], np.float64),
                    config.detail_zoom)
                codes = np.asarray(codes)
                keep = (np.asarray(valid)
                        & (codes >= shard.code_lo)
                        & (codes < shard.code_hi))
                if keep.any():
                    data = {k: np.asarray(v)[keep]
                            for k, v in data.items()}
                else:
                    data = None  # empty range: publish an empty partial
            cap = _CaptureLevels()
            meta = {"points": 0, "content_digest": None}
            if data is not None:
                meta["content_digest"] = columns_digest(data)
                meta["points"] = int(len(next(iter(data.values()))))
                _run_loaded(data, config, as_json=True, sink=cap,
                            device=device)
        return cap.levels, meta

    return execute


# ---------------------------------------------------------------------------
# Simulated-host runner
# ---------------------------------------------------------------------------


def _run_simulated(plan, lineage, execute, *, n_hosts: int,
                   heartbeat_deadline_s, on_straggler: str,
                   speculative_quantile, speculative_factor: float,
                   wedge_host=None, wedge_after: int = 0,
                   wedge_spec: str | None = None,
                   beat_interval_s: float = 0.05,
                   clock=time.monotonic) -> ElasticCoordinator:
    """Drive ``plan`` to completion over ``n_hosts`` worker threads.

    ``wedge_host``/``wedge_after`` model a zombie host for chaos runs:
    once ``wedge_after`` shards have completed anywhere, that host
    stops claiming work but keeps *attempting* heartbeats. At the
    moment the wedge trips, ``wedge_spec`` (e.g.
    ``"scale=0,multihost.heartbeat@p2=999"``) is installed on the
    fault plane, so every later beat is lost in transit through the
    ``multihost.heartbeat`` site — the monitor then sees a live host go
    stale *mid-cascade* with unfinished shards still queued
    (guaranteeing orphans exist, not just suppressed gauges)."""
    hosts = list(range(n_hosts))
    coord = ElasticCoordinator(
        plan, hosts, speculative_quantile=speculative_quantile,
        speculative_factor=speculative_factor)
    abort = threading.Event()
    idle = threading.Event()  # never set; a shared timed-wait primitive
    wedge_armed = threading.Event()
    errors = []

    def worker(host):
        last_beat = None
        try:
            while not abort.is_set():
                now = clock()
                if last_beat is None or now - last_beat >= beat_interval_s:
                    obs.heartbeat("elastic", process=host)
                    last_beat = now
                wedged = (wedge_host is not None and host == wedge_host
                          and coord.done_count() >= wedge_after)
                if wedged and not wedge_armed.is_set():
                    wedge_armed.set()
                    if wedge_spec is not None:
                        faults.install_spec(wedge_spec)
                work = None if wedged else coord.next_work(host, now)
                if work is None:
                    if coord.all_done():
                        return
                    idle.wait(_POLL_S)
                    continue
                shard, mode = work
                if lineage.is_complete(shard):
                    coord.mark_done(shard, host, clock())
                    continue
                site = ("elastic.reassign" if mode == "orphan"
                        else "shard.compute")
                levels, meta = faults.retry_call(
                    execute, shard, site=site, key=shard.index)
                won, quarantined = lineage.publish(shard, host, levels,
                                                   meta)
                coord.mark_done(shard, host, clock())
                if mode == "speculate":
                    orig = coord.owner.get(shard.index)
                    obs.record_speculative_result(
                        shard.index, winner=host if won else orig,
                        loser=orig if won else host,
                        won=won, quarantined=quarantined)
        except BaseException as e:  # noqa: BLE001 — surfaced to the caller
            # Tail-promote the dying worker's trace out of the flight
            # recorder before the caller re-raises (no-op when none).
            from heatmap_tpu_torch.obs import recorder as recorder_mod

            recorder_mod.maybe_promote(error=True)
            errors.append((host, e))
            abort.set()

    workers = [threading.Thread(target=worker, args=(h,),
                                name=f"elastic-h{h}", daemon=True)
               for h in hosts]
    for w in workers:
        w.start()
    straggler = None
    try:
        while any(w.is_alive() for w in workers):
            for w in workers:
                w.join(timeout=_POLL_S)
            if errors or abort.is_set():
                break
            if (heartbeat_deadline_s is not None
                    and obs.get_registry().enabled):
                from heatmap_tpu_torch.parallel.multihost import (
                    StragglerTimeout, check_heartbeats)

                try:
                    check_heartbeats(heartbeat_deadline_s)
                except StragglerTimeout as e:
                    if on_straggler == "raise":
                        straggler = e
                        abort.set()
                        break
                    coord.orphan_stale(e.stale)
    finally:
        if straggler is not None or errors:
            abort.set()
        for w in workers:
            w.join(timeout=5.0)
    if straggler is not None:
        raise straggler
    if errors:
        raise errors[0][1]
    return coord


# ---------------------------------------------------------------------------
# Real-process runner (manifest-based, collective-free)
# ---------------------------------------------------------------------------


def _run_multiprocess(plan, lineage, execute, *, rank: int, n_procs: int,
                      heartbeat_deadline_s, on_straggler: str,
                      clock=time.monotonic):
    """Each process executes its own shards, then polls the shared
    manifest. Failure detection is progress-based (per-process
    registries cannot see remote heartbeats): when no shard completes
    for a full deadline, survivors claim every still-missing shard in
    deterministic order — publish atomicity keeps the merge
    exactly-once even if two survivors double-claim."""
    from heatmap_tpu_torch.parallel.multihost import StragglerTimeout

    deadline = heartbeat_deadline_s or 60.0
    reassigned = 0
    for s in plan:
        if s.index % n_procs != rank or lineage.is_complete(s):
            continue
        levels, meta = faults.retry_call(execute, s, site="shard.compute",
                                         key=s.index)
        lineage.publish(s, f"proc{rank}", levels, meta)
    obs.heartbeat("elastic_own_done")
    waiter = threading.Event()
    last_progress = clock()
    last_count = lineage.completed_count(plan)
    while True:
        pending = [s for s in plan if not lineage.is_complete(s)]
        if not pending:
            break
        count = len(plan) - len(pending)
        if count > last_count:
            last_count, last_progress = count, clock()
        elif clock() - last_progress > deadline:
            stale = {f"proc{s.index % n_procs}": clock() - last_progress
                     for s in pending}
            if on_straggler == "raise":
                raise StragglerTimeout(deadline, stale)
            for s in pending:
                if lineage.is_complete(s):
                    continue
                owner = s.index % n_procs
                obs.record_shard_orphaned(s.index, f"proc{owner}",
                                          reason="no manifest progress")
                obs.record_shard_reassigned(s.index, f"proc{owner}",
                                            f"proc{rank}")
                levels, meta = faults.retry_call(
                    execute, s, site="elastic.reassign", key=s.index)
                won, _ = lineage.publish(s, f"proc{rank}", levels, meta)
                reassigned += int(won)
            last_progress = clock()
        waiter.wait(_POLL_S)
    return reassigned


# ---------------------------------------------------------------------------
# The job entry point
# ---------------------------------------------------------------------------


_PLAN_SAMPLE_ROWS = 1 << 17


def _plan_source_partition(source, config, batch_size: int, n_shards: int):
    """Sample the source's leading batches and build a Morton-range
    PartitionPlan for ``n_shards`` ranges, or None when the source
    yields no projectable rows. Sources are re-iterable (the batch
    executors re-read them), so consuming a prefix here is safe."""
    from heatmap_tpu_torch.parallel.partition import plan_partition

    lats: list[np.ndarray] = []
    lons: list[np.ndarray] = []
    seen = 0
    for batch in source.batches(batch_size):
        lat = np.asarray(batch["latitude"], np.float64)
        lon = np.asarray(batch["longitude"], np.float64)
        lats.append(lat)
        lons.append(lon)
        seen += lat.size
        if seen >= _PLAN_SAMPLE_ROWS:
            break
    if not seen:
        return None
    lat = np.concatenate(lats)[:_PLAN_SAMPLE_ROWS]
    lon = np.concatenate(lons)[:_PLAN_SAMPLE_ROWS]
    codes, valid = _project_detail_codes(lat, lon, config.detail_zoom)
    return plan_partition(np.asarray(codes), n_shards,
                          detail_zoom=config.detail_zoom,
                          valid=np.asarray(valid),
                          n_levels=config.cascade_config().n_levels)


def run_job_elastic(source, sink=None, config=None, *,
                    batch_size: int = 1 << 20,
                    n_total: int | None = None,
                    lineage_dir: str,
                    n_hosts: int | None = None,
                    shards_per_host: int = 2,
                    heartbeat_deadline_s: float | None = None,
                    on_straggler: str = "reassign",
                    speculative_quantile: float | None = None,
                    speculative_factor: float = 2.0,
                    wedge_host=None, wedge_after: int = 0,
                    wedge_spec: str | None = None,
                    beat_interval_s: float = 0.05,
                    partition: str = "batch",
                    clock=time.monotonic, device="cuda") -> dict:
    """Run a batch job elastically: shard-lineage manifest under
    ``lineage_dir``, failover re-execution on straggler timeout,
    optional speculative duplication of stragglers.

    ``partition`` picks the shard geometry: "batch" (default — the
    historical contiguous batch-range slices) or "morton" — a
    Morton-range plan sampled from the source's leading batches
    (parallel/partition.py) assigns each shard one contiguous
    detail-code range spanning ALL batches, so a dead host's failover
    re-executes only its tile ranges and the recovered bytes are
    pinned identical (tools/chaos_soak.py ``host_loss_morton``). A
    degenerate plan (all sampled mass effectively in one range) falls
    back to "batch" with a ``backend_resolved`` audit event. Morton
    shards each re-read the job's batch range and filter to their
    range: the trade is ingest read amplification for range-local
    recovery, the right side of the trade when recompute (cascade)
    dominates re-read (docs/parallel-partitioning.md).

    Single process: ``n_hosts`` simulated hosts (threads) share the
    local devices (``device``); real multi-process: each process is one
    host (see
    the module docstring for the two runners). The output is exact:
    the final merge draws each shard's partial pyramid from exactly one
    manifest winner, and merge_level_dirs re-aggregates rows
    deterministically — an interrupted-and-failed-over run is
    byte-identical to an unfailed one.

    ``sink`` must be columnar (``write_levels``, e.g. arrays:DIR — the
    serve tier reads these directly) or None. ``wedge_host`` /
    ``wedge_after`` / ``clock`` are chaos/test hooks, forwarded from
    ``run_job_multihost(elastic_opts=...)``.
    """
    from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

    config = config or BatchJobConfig()
    if on_straggler not in ("reassign", "raise"):
        raise ValueError(f"unknown on_straggler mode {on_straggler!r}")
    if sink is not None and not hasattr(sink, "write_levels"):
        raise ValueError(
            "elastic egress is columnar: pass a write_levels sink "
            "(arrays:DIR / LevelArraysSink — the serve tier reads "
            "these directly) or sink=None"
        )
    if n_total is None:
        n_total = getattr(source, "n", None)
        if n_total is None:
            raise ValueError(
                "elastic sharding needs n_total (source row count) or a "
                "source with an ``n`` attribute — shards are batch "
                "ranges, so the batch count must be known up front")
    if partition not in ("batch", "morton"):
        raise ValueError(
            f"unknown partition mode {partition!r}: expected 'batch' or "
            "'morton'")
    n_procs = _devices.process_count()
    if n_hosts is None:
        n_hosts = n_procs if n_procs > 1 else 2
    n_batches = max(1, -(-int(n_total) // int(batch_size)))
    job_fp = job_fingerprint(source, config, batch_size, n_total)
    n_shards = n_hosts * max(1, int(shards_per_host))
    code_ranges = None
    if partition == "morton":
        plan_obj = _plan_source_partition(source, config, batch_size,
                                          n_shards)
        if plan_obj is None or plan_obj.degenerate:
            if obs.telemetry_enabled():
                mass = (max(plan_obj.shard_mass or [0.0])
                        if plan_obj is not None else 0.0)
                obs.emit(
                    "backend_resolved",
                    requested="partition=morton",
                    resolved="partition=batch",
                    reason=("degenerate partition plan (max shard mass "
                            f"{mass:.3f}) — Morton ranges would serialize "
                            "the job on one shard; falling back to batch "
                            "ranges"))
        else:
            code_ranges = plan_obj.code_ranges()
    plan = plan_shards(n_batches, n_shards, job_fp,
                       code_ranges=code_ranges)
    lineage = ShardLineage(lineage_dir)
    exec_lock = threading.Lock()
    execute = _make_executor(source, config, batch_size, exec_lock,
                             device=device)

    reassigned = speculated = 0
    if n_procs > 1:
        reassigned = _run_multiprocess(
            plan, lineage, execute, rank=_devices.process_index(),
            n_procs=n_procs, heartbeat_deadline_s=heartbeat_deadline_s,
            on_straggler=on_straggler, clock=clock)
        write = _devices.process_index() == 0
    else:
        coord = _run_simulated(
            plan, lineage, execute, n_hosts=n_hosts,
            heartbeat_deadline_s=heartbeat_deadline_s,
            on_straggler=on_straggler,
            speculative_quantile=speculative_quantile,
            speculative_factor=speculative_factor,
            wedge_host=wedge_host, wedge_after=wedge_after,
            wedge_spec=wedge_spec,
            beat_interval_s=beat_interval_s, clock=clock)
        reassigned, speculated = coord.reassigned, len(coord.speculated)
        write = True
    merged = lineage.merge(plan)
    rows = 0
    if sink is not None and write:
        rows = sink.write_levels(merged)
    return {"egress": "levels-elastic", "levels": len(merged),
            "rows": int(rows), "shards": len(plan),
            "reassigned": int(reassigned), "speculated": int(speculated),
            "lineage_dir": lineage_dir}
