"""Chaos soak: the full pipeline under deterministic fault injection,
byte-identical to a fault-free run.

The port's twin of ``tools/chaos_soak.py``, with every phase and storm
of the JAX tool; the cascades, delta applies, ingest ticks, write-plane
applies and elastic shards run on ``--device`` (the card unless
``--device cpu``), where they launch ``csrc/segment_reduce.cu``.

Drives ingest -> cascade -> delta apply -> compact -> serve twice over
the same synthetic input: once clean, once under a seeded fault plane
(``faults/``) firing hundreds of injected failures across every site:
source reads, sink publishes, journal appends, compaction publishes,
shard compute, tile renders, HTTP requests and lost multihost
heartbeats. The chaos run must converge to the *same bytes*: level
arrays, journal state and every served JSON tile; along the way the
HTTP tier degrades gracefully (typed 503s and stale serves,
``/healthz`` reporting ``degraded``) and never returns a 500.

The other phases, each with its own planes:

- ``ingest_crash``: the continuous-ingest loop under an ``ingest.*``
  storm the retries absorb, then a kill mid-tick whose restart heals
  exactly-once and serves byte-identical to a one-shot apply;
- ``writer_loss``: the write plane's absorbed storm, one of three
  writers killed, a restart re-drain healing it;
- ``dispatch``: ``feeder.put`` storms on the CUDA-stream feeder
  (``pipeline/feeder.py``): an absorbed fault re-feeds the same batch
  invisibly, a kill mid-feed leaves exactly the fed-ahead ticks
  journaled, the restart re-feeds the crashed batch exactly-once;
- ``host_loss``/``host_loss_morton``: one simulated host stops
  heartbeating mid-cascade; the elastic layer reassigns its shards (only
  its Morton ranges) with byte-identical arrays and tiles;
- ``backend_loss``: a SIGKILLed backend of a 3-process serve fleet
  under Zipf load (its children open no CUDA context): zero 5xx, the
  breaker opens and re-closes, bytes equal to the clean run;
- ``synopsis``/``query``/``temporal``/``tilefs``: a torn synopsis,
  integral, time bucket or tilefs mirror is quarantined by the recovery
  sweep while serving falls back to exact (or last-good) bytes, never a
  500;
- ``incident``/``telemetry``/``adaptive``: the flight recorder's
  bundles, the anomaly engine and telemetry spills, and the brownout
  ladder under fake clocks.

    python -m heatmap_tpu_torch.tools.chaos_soak [--n 3000] [--chaos SPEC]
        [--keep] [--only PHASE] [--incident-dir DIR] [--device cuda|cpu]

Every phase reports one JSON line (the JAX tool's keys); the last line
names the device (``device``, and on a card ``gpu_name`` and
``power_limit_w``). The exit code is non-zero if any phase failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

from heatmap_tpu_torch import delta, faults, obs
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.io.sources import SyntheticSource
from heatmap_tpu_torch.parallel.multihost import (StragglerTimeout,
                                                  check_heartbeats,
                                                  run_job_multihost)
from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job
from heatmap_tpu_torch.serve import (ServeApp, TileCache, TileStore,
                                     serve_in_thread)
from heatmap_tpu_torch.tilemath.morton import morton_decode_np
from heatmap_tpu_torch.utils.recovery import run_shards

CFG = BatchJobConfig(detail_zoom=10, min_detail_zoom=8, result_delta=2)

#: Default plane: count rules spaced so transient bursts stay inside
#: each site's retry budget (faults/retry.py POLICIES), probability
#: rules on the serve tier where the HTTP client retries 503s.
DEFAULT_CHAOS = ",".join([
    "seed=11", "scale=0",
    "source.read=60x2",
    "sink.write=30x2",
    "journal.append=8x2",
    "compact.publish=4x2",
    "shard.compute=40x3",
    "tile.render=p0.3",
    "http.request=p0.2",
    "multihost.heartbeat=6x2",
])

FETCH_ATTEMPTS = 64  # per-URL 503-retry budget under probability rules

#: Ingest-phase storms (the continuous loop has its own plane: the
#: chaos plane above is spent by the time the ingest phase runs).
#: Absorbed storm: one ingest.tick + one ingest.publish fault per tick,
#: inside both retry budgets, so the loop result must be unchanged.
INGEST_CHAOS = "seed=13,scale=0,ingest.tick=2x2,ingest.publish=2x2"
#: Kill storm: every journal append fails past the whole retry stack
#: (3 ingest.tick attempts x 4 journal.append attempts), crashing the
#: first non-duplicate tick AFTER its artifact dir is written — the
#: torn state delta/recover.py heals on the next run's startup sweep.
INGEST_KILL = "seed=13,scale=0,journal.append=99"

#: Write-plane storms (the writer_loss phase installs its own planes).
#: Absorbed storm: spaced writeplane.append + writeplane.publish
#: faults, each inside its site's retry budget — the 3-writer drain
#: must complete with zero failed batches and byte-identical output.
WRITEPLANE_CHAOS = ("seed=17,scale=0,"
                    "writeplane.append=4x3,writeplane.publish=2x3")
#: Kill storm: every apply on range r001 fails past the whole retry
#: budget — that pump dies mid-run (writer loss), the survivors keep
#: applying and publishing manifest epochs, and the dead range's
#: batches are never ledgered, so a restart re-drain heals them
#: exactly-once.
WRITEPLANE_KILL = "seed=17,scale=0,writeplane.append@r001=99"


# ---------------------------------------------------------------- pipeline

def _pipeline(root: str, arrays_dir: str, n: int, device):
    """Ingest -> cascade -> 3 delta applies -> compact -> post-compact
    apply. Identical call sequence for the clean and chaos runs."""
    run_job(SyntheticSource(n=n, seed=7), LevelArraysSink(arrays_dir),
            config=CFG, batch_size=512, device=device)
    shards = [(i, min(i + 8, 96)) for i in range(0, 96, 8)]
    digests = run_shards(shards, lambda s: s[1] - s[0], retries=2)
    applies = [
        delta.apply_batch(root, SyntheticSource(n=n // 3, seed=1), CFG,
                          batch_size=256, device=device),
        delta.apply_batch(root, SyntheticSource(n=n // 3, seed=2), CFG,
                          batch_size=256, device=device),
        delta.apply_batch(root, SyntheticSource(n=n // 4, seed=3), CFG,
                          batch_size=256, device=device),
    ]
    summary = delta.compact(root)
    post = delta.apply_batch(root, SyntheticSource(n=n // 5, seed=4), CFG,
                             batch_size=256, device=device)
    return {"shard_rows": int(sum(digests)),
            "epochs": [r.epoch for r in applies + [post]],
            "compact": summary.get("base"),
            "points": int(sum(r.points for r in applies + [post]))}


def _tile_coords(store: TileStore):
    """Every servable JSON tile of every layer, from the stored Morton
    codes (the tests/test_delta.py enumeration)."""
    coords = []
    for name, layer in sorted(store.layers.items()):
        if name == "default":
            continue
        shift = 2 * layer.result_delta
        for want, level in layer.levels.items():
            z = want - layer.result_delta
            if z < 0:
                continue
            rows, cols = morton_decode_np(np.unique(level.codes >> shift))
            for r, c in zip(rows, cols):
                coords.append((name, z, int(c), int(r)))
    return coords


def _get(url: str):
    """-> (status, body). 503s come back as data, not exceptions."""
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _fetch_all(base: str, coords, ctx):
    """Fetch every tile, retrying typed 503s; record status codes and
    whether /healthz reported ``degraded`` while render faults were
    live. Any 500, or a URL that never converges, is a failure."""
    docs, probes = {}, 0
    for name, z, x, y in coords:
        url = (f"{base}/tiles/{urllib.parse.quote(name, safe='')}"
               f"/{z}/{x}/{y}.json")
        for attempt in range(FETCH_ATTEMPTS):
            status, body = _get(url)
            ctx["codes"][status] = ctx["codes"].get(status, 0) + 1
            assert status != 500, f"HTTP 500 from {url}: {body[:200]!r}"
            if status == 200:
                docs[(name, z, x, y)] = body
                break
            assert status == 503, f"unexpected {status} from {url}"
            # A render fault just degraded the app: /healthz must say so
            # (itself retried through http.request faults).
            if b"render" in body and not ctx["saw_degraded"] and probes < 8:
                probes += 1
                for _ in range(FETCH_ATTEMPTS):
                    hs, hb = _get(f"{base}/healthz")
                    assert hs != 500
                    if hs == 200:
                        health = json.loads(hb)
                        if health.get("status") == "degraded":
                            ctx["saw_degraded"] = True
                            ctx["degraded_causes"] = health.get("degraded")
                        break
        else:
            raise AssertionError(f"{url} never returned 200 in "
                                 f"{FETCH_ATTEMPTS} attempts")
    return docs


def _serve_docs(root: str, ctx=None, kind: str = "delta"):
    """Serve a store root over real HTTP and fetch every tile."""
    ctx = ctx if ctx is not None else {"codes": {}, "saw_degraded": False}
    store = TileStore(f"{kind}:{root}")
    app = ServeApp(store, TileCache(max_bytes=64 << 20),
                   render_timeout_s=30.0)
    server, base = serve_in_thread(app)
    try:
        docs = _fetch_all(base, _tile_coords(store), ctx)
    finally:
        server.shutdown()
    ctx["docs"] = docs
    return ctx


def _replay(bundle_dir: str) -> dict:
    """The span trees of an incident bundle's ``trace.json``: span count
    and, per root, its name, whether its parent is missing from the file
    and its critical path (root to leaf, into the longest child)."""
    with open(os.path.join(bundle_dir, "trace.json")) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    spans = [{"name": e.get("name", "?"), "dur": float(e.get("dur", 0.0)),
              "ts": float(e.get("ts", 0.0)), **e["args"]}
             for e in events
             if e.get("ph") == "X" and "span_id" in (e.get("args") or {})]
    by_id = {(s["trace_id"], s["span_id"]): s for s in spans}
    kids: dict = {}
    roots = []
    for s in spans:
        parent = (s["trace_id"], s.get("parent_id"))
        if s.get("parent_id") is not None and parent in by_id:
            kids.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    traces = []
    for root in sorted(roots, key=lambda s: s["ts"]):
        path, node = [root["name"]], root
        while kids.get((node["trace_id"], node["span_id"])):
            node = max(kids[(node["trace_id"], node["span_id"])],
                       key=lambda s: s["dur"])
            path.append(node["name"])
        traces.append({"root": root["name"],
                       "partial": root.get("parent_id") is not None,
                       "critical_path": path})
    return {"n_spans": len(spans), "traces": traces}


def _levels_bytes(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if os.path.isfile(full):
            with open(full, "rb") as f:
                out[name] = f.read()
    return out


# ------------------------------------------------------------------ phases

def phase_baseline(ctx):
    faults.install(None)
    t0 = time.monotonic()
    info = _pipeline(ctx["base_root"], ctx["base_arrays"], ctx["n"],
                     ctx["device"])
    served = _serve_docs(ctx["base_root"])
    ctx["base_docs"] = served["docs"]
    assert served["codes"].get(500, 0) == 0
    return {**info, "tiles": len(served["docs"]),
            "seconds": round(time.monotonic() - t0, 1)}


def phase_chaos_pipeline(ctx):
    plane = faults.install_spec(ctx["chaos"])
    t0 = time.monotonic()
    info = _pipeline(ctx["chaos_root"], ctx["chaos_arrays"], ctx["n"],
                     ctx["device"])
    return {**info, "faults_so_far": plane.injected,
            "seconds": round(time.monotonic() - t0, 1)}


def phase_chaos_serve(ctx):
    """Serve the chaos store while render/request faults are still
    firing: every tile must converge to 200 (typed 503s in between,
    never a 500) and /healthz must report ``degraded`` mid-storm."""
    served = _serve_docs(ctx["chaos_root"],
                         ctx.setdefault("serve_ctx",
                                        {"codes": {}, "saw_degraded": False}))
    ctx["chaos_docs"] = served["docs"]
    codes = served["codes"]
    assert codes.get(500, 0) == 0, f"500s observed: {codes}"
    assert codes.get(503, 0) > 0, \
        f"soak never exercised the degraded path: {codes}"
    assert served["saw_degraded"], "/healthz never reported degraded"
    return {"codes": {str(k): v for k, v in sorted(codes.items())},
            "tiles": len(served["docs"]),
            "degraded_causes": served.get("degraded_causes")}


def phase_heartbeat(ctx):
    """Lost-heartbeat detection: injected multihost.heartbeat faults
    suppress the liveness gauge, and the deadline monitor raises a
    typed StragglerTimeout once the surviving mark goes stale."""
    obs.enable_metrics(True)
    try:
        plane = faults.get_plane()
        before = plane.counts().get("multihost.heartbeat", 0)
        for _ in range(12):
            obs.heartbeat("soak")  # every other one is lost in transit
        lost = plane.counts().get("multihost.heartbeat", 0) - before
        assert lost >= 4, f"heartbeat faults never fired ({lost})"
        ages = check_heartbeats(deadline_s=3600.0)  # fresh: no straggler
        try:
            check_heartbeats(deadline_s=0.5, now=time.time() + 10)
        except StragglerTimeout as e:
            stale = e.stale
        else:
            raise AssertionError("stale heartbeats went undetected")
        return {"lost": lost, "ages": {k: round(v, 3) for k, v in
                                       ages.items()},
                "stale_processes": sorted(stale)}
    finally:
        obs.enable_metrics(False)


def phase_fault_floor(ctx):
    """The acceptance floor: >= 200 injected faults across >= 6 sites."""
    counts = faults.get_plane().counts()
    total = sum(counts.values())
    assert total >= 200, f"only {total} faults injected: {counts}"
    assert len(counts) >= 6, f"only {len(counts)} sites fired: {counts}"
    ctx["fault_counts"] = counts
    return {"total": total, "sites": counts}


def phase_byte_equality(ctx):
    """The anchor: the chaos run's bytes are identical to the clean
    run's — level arrays from the cascade AND every served tile."""
    faults.install(None)
    a = _levels_bytes(ctx["base_arrays"])
    b = _levels_bytes(ctx["chaos_arrays"])
    assert sorted(a) == sorted(b), "level-array file sets diverged"
    for name in a:
        assert a[name] == b[name], f"level arrays diverged at {name}"
    base, chaos = ctx["base_docs"], ctx["chaos_docs"]
    assert sorted(base) == sorted(chaos), (
        f"served tile sets diverged: {len(base)} vs {len(chaos)}")
    mism = [k for k in base if base[k] != chaos[k]]
    assert not mism, f"{len(mism)} tiles diverged, e.g. {mism[:3]}"
    # Fault-free aftermath: the degraded flags cleared and the chaos
    # store serves clean (no stale 503s linger once the plane is gone).
    served = _serve_docs(ctx["chaos_root"])
    assert served["codes"].get(503, 0) == 0
    assert served["codes"].get(500, 0) == 0
    return {"levels": len(a), "tiles": len(base),
            "clean_refetch_codes": {str(k): v for k, v in
                                    sorted(served["codes"].items())}}


def phase_ingest_crash(ctx):
    """The continuous-ingest loop under an ``ingest.*`` storm with a
    kill mid-tick: absorbed faults are invisible in the outcome, the
    killed run heals exactly-once on restart (duplicates no-op, the
    crashed batch re-journals, the orphan artifact is swept), and the
    recovered store serves byte-identical to a one-shot apply of the
    same points. Runs after fault_floor — it installs its own planes."""
    from heatmap_tpu_torch import ingest

    n, dev = ctx["n"], ctx["device"]
    cols: dict = {}
    for batch in SyntheticSource(n=n, seed=21).batches(1 << 20):
        for c, v in batch.items():
            cols.setdefault(c, []).extend(v)
    micro = max(1, -(-n // 4))  # 4 ticks
    ticks_total = -(-n // micro)
    root = os.path.join(os.path.dirname(ctx["base_root"]), "store-ingest")
    # The loop runs the bucketed compile cache; the one-shot reference
    # stays exact — byte-neutrality of the padding is part of the soak.
    icfg = BatchJobConfig(detail_zoom=10, min_detail_zoom=8,
                          result_delta=2, pad_bucketing="pow2",
                          pad_bucket_min=1 << 8)

    # A live store rides through the whole phase so every tick also
    # publishes (exercising the ingest.publish site and its faults).
    delta.init_store(root)
    store, cache = TileStore(f"delta:{root}"), TileCache()

    # 1. Absorbed storm: the first two ticks land despite one tick
    #    fault and one publish fault each (inside the retry budgets).
    plane = faults.install_spec(INGEST_CHAOS)
    first = ingest.run_ingest(
        root, delta.ColumnsSource(cols), icfg, store=store, cache=cache,
        ingest=ingest.IngestConfig(micro_batch=micro, queue_depth=2,
                                   compact_every=0, max_ticks=2),
        device=dev)
    absorbed = plane.injected
    assert first.ticks == 2 and first.duplicates == 0, vars(first)
    assert absorbed >= 4, f"absorbed storm never fired ({absorbed})"

    # 2. Kill mid-tick: duplicates sail through (the dedup path never
    #    reaches journal.append), the first fresh tick dies with its
    #    artifact dir orphaned.
    faults.install_spec(INGEST_KILL)
    try:
        ingest.run_ingest(root, delta.ColumnsSource(cols), icfg,
                          store=store, cache=cache,
                          ingest=ingest.IngestConfig(micro_batch=micro,
                                                     queue_depth=2,
                                                     compact_every=0),
                          device=dev)
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("kill storm never crashed the loop")
    faults.install(None)
    assert len(delta.live_entries(root)) == 2, "crashed tick journaled"

    # 3. Recovery: re-drain the whole source; exactly-once epochs.
    stats = ingest.run_ingest(root, delta.ColumnsSource(cols), icfg,
                              store=store, cache=cache,
                              ingest=ingest.IngestConfig(
                                  micro_batch=micro, queue_depth=2,
                                  compact_every=0), device=dev)
    assert stats.ticks == ticks_total and stats.duplicates == 2, \
        vars(stats)
    live = delta.live_entries(root)
    hashes = [e["content_hash"] for e in live]
    assert len(live) == ticks_total and len(set(hashes)) == ticks_total
    epochs = [e["epoch"] for e in live]
    assert epochs == sorted(epochs)

    # 4. Byte identity vs a one-shot apply of the union.
    ref = os.path.join(os.path.dirname(ctx["base_root"]),
                       "store-ingest-ref")
    delta.apply_batch(ref, delta.ColumnsSource(cols),
                      BatchJobConfig(detail_zoom=10, min_detail_zoom=8,
                                     result_delta=2), device=dev)
    got = _serve_docs(root)["docs"]
    want = _serve_docs(ref)["docs"]
    assert sorted(got) == sorted(want), (
        f"served tile sets diverged: {len(got)} vs {len(want)}")
    mism = [k for k in want if got[k] != want[k]]
    assert not mism, f"{len(mism)} tiles diverged, e.g. {mism[:3]}"
    return {"ticks": ticks_total, "absorbed_faults": absorbed,
            "epochs": epochs, "tiles": len(got)}


def phase_writer_loss(ctx):
    """The partitioned write plane under its own storms: an absorbed
    append/publish storm is invisible in the outcome; killing 1 of 3
    writers mid-apply leaves the survivors applying and publishing
    manifest epochs; a restart re-drain of the same stream heals the
    dead range exactly-once and the plane serves byte-identical to a
    single-writer delta store fed the same micro-batches."""
    from heatmap_tpu_torch.writeplane import PlaneConfig, WritePlane, \
        run_plane_ingest

    n, dev = ctx["n"], ctx["device"]
    wcfg = BatchJobConfig(detail_zoom=10, min_detail_zoom=8,
                          result_delta=2)
    micro = max(1, -(-n // 6))  # 6 micro-batches
    base_dir = os.path.dirname(ctx["base_root"])

    # Single-writer reference over the same micro-batches.
    ref = os.path.join(base_dir, "store-wp-ref")
    for batch in SyntheticSource(n=n, seed=23).batches(micro):
        delta.apply_batch(ref, delta.ColumnsSource(batch), wcfg,
                          device=dev)

    # 1. Absorbed storm: spaced append + publish faults inside the
    #    retry budgets — the drain completes as if nothing happened.
    root_a = os.path.join(base_dir, "wp-absorbed")
    plane = faults.install_spec(WRITEPLANE_CHAOS)
    stats = run_plane_ingest(
        WritePlane(root_a, wcfg, PlaneConfig(n_writers=3), device=dev),
        SyntheticSource(n=n, seed=23), micro_batch=micro)
    absorbed = plane.injected
    faults.install(None)
    assert stats.failed == 0 and stats.completed == stats.batches, \
        vars(stats)
    assert absorbed >= 4, f"absorbed storm never fired ({absorbed})"
    got = _serve_docs(root_a, kind="writeplane")["docs"]
    want = _serve_docs(ref)["docs"]
    assert sorted(got) == sorted(want) and all(
        got[k] == want[k] for k in want), "absorbed storm changed bytes"

    # 2. Writer loss: r001's pump dies terminally mid-run; the other
    #    two writers keep applying and the manifest keeps advancing.
    root_k = os.path.join(base_dir, "wp-killed")
    faults.install_spec(WRITEPLANE_KILL)
    stats = run_plane_ingest(
        WritePlane(root_k, wcfg, PlaneConfig(n_writers=3), device=dev),
        SyntheticSource(n=n, seed=23), micro_batch=micro)
    faults.install(None)
    assert stats.pumps["r001"].dead, "kill storm never killed the pump"
    assert stats.failed > 0
    assert stats.epoch > 1, "survivors stopped publishing"
    survivors = [p for name, p in stats.pumps.items() if name != "r001"]
    assert any(p.applied for p in survivors), "survivors applied nothing"

    # 3. Restart re-drain heals exactly-once: survivors' sub-batches
    #    dedup in their range journals, r001 applies its missing
    #    halves, and the plane converges to the reference bytes.
    heal = run_plane_ingest(
        WritePlane(root_k, wcfg, PlaneConfig(n_writers=3), device=dev),
        SyntheticSource(n=n, seed=23), micro_batch=micro)
    assert heal.failed == 0, vars(heal)
    got = _serve_docs(root_k, kind="writeplane")["docs"]
    assert sorted(got) == sorted(want), (
        f"served tile sets diverged: {len(got)} vs {len(want)}")
    mism = [k for k in want if got[k] != want[k]]
    assert not mism, f"{len(mism)} tiles diverged, e.g. {mism[:3]}"
    return {"absorbed_faults": absorbed, "batches": stats.batches,
            "healed_duplicates": heal.duplicates, "tiles": len(got)}


#: dispatch-phase storms (the feeder has its own planes, installed
#: here). Absorbed storm: two spaced ``feeder.put`` faults, each inside
#: the site's retry budget, so the re-fed batches are invisible.
DISPATCH_CHAOS = "seed=31,scale=0,feeder.put=2x2"
#: Kill storm: batch index 2's transfer fails past the whole retry
#: budget — the loop crashes mid-feed after the fed-ahead ticks landed.
DISPATCH_KILL = "seed=31,scale=0,feeder.put@2=99"


def phase_dispatch(ctx):
    """The double-buffered feeder (pipeline/feeder.py) under a
    ``feeder.put`` storm with a kill mid-feed: absorbed faults re-feed
    the same batch invisibly (``device_put`` is idempotent), the killed
    run crashes with exactly the fed-ahead ticks journaled, the restart
    re-feeds the crashed batch and the journal's content hashes keep
    every batch exactly-once, and the recovered store serves
    byte-identical to a one-shot apply of the same points. The overlap
    telemetry must show the feeder actually ran ahead. Installs its own
    planes (runs after fault_floor)."""
    from heatmap_tpu_torch import ingest
    from heatmap_tpu_torch.parallel.mesh import local_devices

    n, dev = ctx["n"], ctx["device"]
    cols: dict = {}
    for batch in SyntheticSource(n=n, seed=23).batches(1 << 20):
        for c, v in batch.items():
            cols.setdefault(c, []).extend(v)
    micro = max(1, -(-n // 6))  # 6 ticks: 2 land, 1 killed, 3 recovered
    ticks_total = -(-n // micro)
    assert ticks_total >= 4, ticks_total
    root = os.path.join(os.path.dirname(ctx["base_root"]),
                        "store-dispatch")
    # Multi-device runs soak the one-program gspmd dispatch under the
    # storm too (parallel/gspmd.py); single-device runs still pin the
    # feeder contract on the plain path.
    dcfg = BatchJobConfig(detail_zoom=10, min_detail_zoom=8,
                          result_delta=2,
                          data_parallel=True
                          if len(local_devices(dev)) > 1 else None)
    icfg = ingest.IngestConfig(micro_batch=micro, queue_depth=2,
                               compact_every=0, feed_depth=1)

    delta.init_store(root)
    store, cache = TileStore(f"delta:{root}"), TileCache()

    # 1. Absorbed storm: the first two ticks land despite one transfer
    #    fault each (inside the feeder.put retry budget).
    plane = faults.install_spec(DISPATCH_CHAOS)
    first = ingest.run_ingest(
        root, delta.ColumnsSource(cols), dcfg, store=store, cache=cache,
        ingest=dataclasses.replace(icfg, max_ticks=2), device=dev)
    absorbed = plane.injected
    assert first.ticks == 2 and first.duplicates == 0, vars(first)
    assert absorbed >= 2, f"absorbed storm never fired ({absorbed})"

    # 2. Kill mid-feed: duplicates of the landed ticks sail through the
    #    feeder, then batch 2's transfer dies past its retries — the
    #    worker aborts, the in-flight batches drain, and the loop
    #    crashes with nothing new journaled.
    faults.install_spec(DISPATCH_KILL)
    try:
        ingest.run_ingest(root, delta.ColumnsSource(cols), dcfg,
                          store=store, cache=cache, ingest=icfg, device=dev)
    except faults.InjectedFault as e:
        assert e.site == "feeder.put", e
    else:
        raise AssertionError("feeder kill never crashed the loop")
    faults.install(None)
    assert len(delta.live_entries(root)) == 2, "crashed feed journaled"

    # 3. Recovery: re-drain the whole source; the crashed batch is
    #    re-fed and every batch lands exactly once.
    stats = ingest.run_ingest(root, delta.ColumnsSource(cols), dcfg,
                              store=store, cache=cache, ingest=icfg,
                              device=dev)
    assert stats.ticks == ticks_total and stats.duplicates == 2, \
        vars(stats)
    assert stats.feeder_depth_hwm >= 1, vars(stats)
    live = delta.live_entries(root)
    hashes = [e["content_hash"] for e in live]
    assert len(live) == ticks_total and len(set(hashes)) == ticks_total
    epochs = [e["epoch"] for e in live]
    assert epochs == sorted(epochs)

    # 4. Byte identity vs a one-shot (unfed, single-dispatch) apply.
    ref = os.path.join(os.path.dirname(ctx["base_root"]),
                       "store-dispatch-ref")
    delta.apply_batch(ref, delta.ColumnsSource(cols),
                      BatchJobConfig(detail_zoom=10, min_detail_zoom=8,
                                     result_delta=2), device=dev)
    got = _serve_docs(root)["docs"]
    want = _serve_docs(ref)["docs"]
    assert sorted(got) == sorted(want), (
        f"served tile sets diverged: {len(got)} vs {len(want)}")
    mism = [k for k in want if got[k] != want[k]]
    assert not mism, f"{len(mism)} tiles diverged, e.g. {mism[:3]}"
    return {"ticks": ticks_total, "absorbed_faults": absorbed,
            "refed_batch": 2, "epochs": epochs,
            "feed_overlap_pct": round(stats.feed_overlap_pct, 1),
            "feeder_depth_hwm": stats.feeder_depth_hwm,
            "tiles": len(got)}


#: host_loss wedge: the wedged worker installs this spec the moment it
#: stops beating, so simulated host 2 is alive and visible up to that
#: point and every later beat is eaten by the ``multihost.heartbeat``
#: fault site — a mid-cascade host death, not a host that never joined.
HOST_LOSS_WEDGE = "seed=29,scale=0,multihost.heartbeat@p2=999"


def phase_host_loss(ctx):
    """Elastic execution under a mid-cascade host death: one simulated
    host completes a shard then stops heartbeating (its beats are eaten
    by the ``multihost.heartbeat`` fault site); the monitor flags it
    stale, its shards are reassigned to the survivors, the job
    completes, and the merged level arrays AND every served tile are
    byte-identical to an unfailed elastic run."""
    faults.install(None)
    tmp = os.path.dirname(ctx["base_root"])
    src = lambda: SyntheticSource(n=ctx["n"], seed=3)  # noqa: E731
    bs = max(1, ctx["n"] // 6)  # 6 batches -> 6 shards over 3 hosts
    obs.enable_metrics(True)
    try:
        obs.get_registry().reset()
        ok = run_job_multihost(
            src(), LevelArraysSink(os.path.join(tmp, "arrays-elastic-ok")),
            CFG, batch_size=bs, on_straggler="reassign",
            elastic_dir=os.path.join(tmp, "elastic-ok"), elastic_hosts=3,
            device=ctx["device"])
        obs.get_registry().reset()
        lost = run_job_multihost(
            src(), LevelArraysSink(os.path.join(tmp, "arrays-elastic-loss")),
            CFG, batch_size=bs, heartbeat_deadline_s=0.3,
            on_straggler="reassign",
            elastic_dir=os.path.join(tmp, "elastic-loss"), elastic_hosts=3,
            elastic_opts={"wedge_host": 2, "wedge_after": 1,
                          "wedge_spec": HOST_LOSS_WEDGE,
                          "beat_interval_s": 0.05},
            device=ctx["device"])
        reassigned_metric = obs.ELASTIC_REASSIGNMENTS.value()
    finally:
        faults.install(None)  # the wedge installed its own plane
        obs.enable_metrics(False)
    assert ok["rows"] == lost["rows"], (ok, lost)
    assert lost["reassigned"] > 0, f"no shards were reassigned: {lost}"
    assert reassigned_metric > 0, \
        f"elastic_reassignments_total stayed 0: {lost}"
    a = _levels_bytes(os.path.join(tmp, "arrays-elastic-ok"))
    b = _levels_bytes(os.path.join(tmp, "arrays-elastic-loss"))
    assert sorted(a) == sorted(b), "elastic level-array file sets diverged"
    for name in a:
        assert a[name] == b[name], f"elastic arrays diverged at {name}"
    # Served tiles from the failed run's arrays, byte-for-byte.
    docs = {}
    for which in ("arrays-elastic-ok", "arrays-elastic-loss"):
        store = TileStore(f"arrays:{os.path.join(tmp, which)}")
        app = ServeApp(store, TileCache(max_bytes=64 << 20),
                       render_timeout_s=30.0)
        server, base = serve_in_thread(app)
        try:
            docs[which] = _fetch_all(
                base, _tile_coords(store),
                {"codes": {}, "saw_degraded": False})
        finally:
            server.shutdown()
    want, got = docs["arrays-elastic-ok"], docs["arrays-elastic-loss"]
    assert sorted(want) == sorted(got), (
        f"served tile sets diverged: {len(want)} vs {len(got)}")
    mism = [k for k in want if want[k] != got[k]]
    assert not mism, f"{len(mism)} tiles diverged, e.g. {mism[:3]}"
    return {"shards": lost["shards"], "reassigned": lost["reassigned"],
            "reassignments_metric": reassigned_metric,
            "levels": len(a), "tiles": len(want)}


def phase_host_loss_morton(ctx):
    """host_loss under Morton-range elastic shards: the same
    mid-cascade host death, but every shard owns a contiguous
    detail-code range (parallel/partition.py), so failover must
    re-execute ONLY the dead host's tile ranges. Pinned through the
    ``shard_reassigned`` audit events — every reassigned shard index
    must have belonged to the wedged host — on top of the usual bar:
    merged arrays and served tiles byte-identical to an unfailed
    Morton run."""
    faults.install(None)
    tmp = os.path.dirname(ctx["base_root"])
    src = lambda: SyntheticSource(n=ctx["n"], seed=3)  # noqa: E731
    bs = max(1, ctx["n"] // 6)
    events_path = os.path.join(tmp, "morton-loss-events.jsonl")
    obs.enable_metrics(True)
    try:
        obs.get_registry().reset()
        ok = run_job_multihost(
            src(),
            LevelArraysSink(os.path.join(tmp, "arrays-morton-ok")),
            CFG, batch_size=bs, on_straggler="reassign",
            elastic_dir=os.path.join(tmp, "elastic-morton-ok"),
            elastic_hosts=3, elastic_opts={"partition": "morton"},
            device=ctx["device"])
        obs.get_registry().reset()
        obs.set_event_log(obs.EventLog(events_path))
        lost = run_job_multihost(
            src(),
            LevelArraysSink(os.path.join(tmp, "arrays-morton-loss")),
            CFG, batch_size=bs, heartbeat_deadline_s=0.3,
            on_straggler="reassign",
            elastic_dir=os.path.join(tmp, "elastic-morton-loss"),
            elastic_hosts=3,
            elastic_opts={"wedge_host": 2, "wedge_after": 1,
                          "wedge_spec": HOST_LOSS_WEDGE,
                          "beat_interval_s": 0.05,
                          "partition": "morton"},
            device=ctx["device"])
    finally:
        faults.install(None)
        log = obs.get_event_log()
        obs.set_event_log(None)
        if log is not None:
            log.close()
        obs.enable_metrics(False)
    assert lost["reassigned"] > 0, f"no shards were reassigned: {lost}"
    events = list(obs.read_events(events_path))
    planned = [e for e in events if e["event"] == "partition_planned"]
    assert planned, "morton elastic run never planned a partition"
    reas = [e for e in events if e["event"] == "shard_reassigned"]
    assert reas, "no shard_reassigned audit events"
    # The locality pin: reassignment touched ONLY the dead host's
    # ranges (shard index i belongs to host i % n_hosts).
    foreign = [e for e in reas if str(e["from_host"]) != "2"]
    assert not foreign, f"non-dead-host ranges re-executed: {foreign}"
    a = _levels_bytes(os.path.join(tmp, "arrays-morton-ok"))
    b = _levels_bytes(os.path.join(tmp, "arrays-morton-loss"))
    assert sorted(a) == sorted(b), "morton level-array file sets diverged"
    for name in a:
        assert a[name] == b[name], f"morton arrays diverged at {name}"
    docs = {}
    for which in ("arrays-morton-ok", "arrays-morton-loss"):
        store = TileStore(f"arrays:{os.path.join(tmp, which)}")
        app = ServeApp(store, TileCache(max_bytes=64 << 20),
                       render_timeout_s=30.0)
        server, base = serve_in_thread(app)
        try:
            docs[which] = _fetch_all(
                base, _tile_coords(store),
                {"codes": {}, "saw_degraded": False})
        finally:
            server.shutdown()
    want, got = docs["arrays-morton-ok"], docs["arrays-morton-loss"]
    assert sorted(want) == sorted(got), "served tile sets diverged"
    mism = [k for k in want if want[k] != got[k]]
    assert not mism, f"{len(mism)} tiles diverged, e.g. {mism[:3]}"
    return {"shards": lost["shards"], "reassigned": lost["reassigned"],
            "reassigned_from_dead_host_only": True,
            "planned_events": len(planned), "ok_shards": ok["shards"],
            "levels": len(a), "tiles": len(want)}


def phase_backend_loss(ctx):
    """Serve-fleet resilience: SIGKILL one backend of a 3-process fleet
    under Zipf load. The router's connection-failure retry must keep
    the client at zero 5xx, the victim's breaker must open
    (``fleet_backend_down``) and re-close through the supervisor
    restart + half-open probe (``fleet_backend_up``), and every tile
    served through the fleet afterwards must be byte-identical to the
    clean single-process run (``base_docs``)."""
    from heatmap_tpu_torch.serve.fleet import FleetSupervisor

    faults.install(None)
    spec = f"delta:{ctx['base_root']}"
    coords = _tile_coords(TileStore(spec))
    tmp = os.path.dirname(ctx["base_root"])
    events_path = os.path.join(tmp, "fleet-events.jsonl")
    ev_log = obs.EventLog(events_path)
    obs.set_event_log(ev_log)
    codes: dict = {}
    lock = threading.Lock()
    stop = threading.Event()
    sup = FleetSupervisor(spec, 3, cache_bytes=64 << 20,
                          render_timeout_s=30.0, probe_interval_s=0.2,
                          restart_base_s=0.1, restart_cap_s=1.0)
    try:
        sup.start()
        server, base = serve_in_thread(sup.router)

        def load_loop(seed):
            rng = random.Random(seed)
            while not stop.is_set():
                # The load_gen 80/20 skew: hot-set traffic plus a tail.
                if rng.random() < 0.8:
                    name, z, x, y = coords[rng.randrange(
                        max(1, len(coords) // 5))]
                else:
                    name, z, x, y = coords[rng.randrange(len(coords))]
                status, _ = _get(
                    f"{base}/tiles/{urllib.parse.quote(name, safe='')}"
                    f"/{z}/{x}/{y}.json")
                with lock:
                    codes[status] = codes.get(status, 0) + 1

        drivers = [threading.Thread(target=load_loop, args=(i,),
                                    daemon=True) for i in range(4)]
        for t in drivers:
            t.start()
        time.sleep(1.0)  # warm traffic across the whole ring
        victim = sorted(sup.router.backends)[0]
        sup.kill_backend(victim)
        # Two-stage wait: right after SIGKILL the breaker has not yet
        # tripped, so /healthz still reports a full ring — polling for
        # eligible==3 straight away would "recover" instantly. First
        # wait for the victim to actually leave the ring, then for the
        # supervisor restart + half-open probe to re-admit it.
        def wait_ring(pred, what, timeout_s):
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                status, body = _get(f"{base}/healthz")
                if status == 200:
                    eligible = json.loads(body)["fleet"]["eligible"]
                    if pred(eligible):
                        return
                time.sleep(0.05)
            raise AssertionError(f"victim {victim} never {what}: {codes}")

        wait_ring(lambda e: victim not in e, "left the ring", 30.0)
        wait_ring(lambda e: victim in e and len(e) == 3,
                  "re-admitted", 60.0)
        time.sleep(0.5)  # a little post-recovery traffic
        stop.set()
        for t in drivers:
            t.join(timeout=10.0)
        fives = {s: c for s, c in codes.items() if 500 <= s < 600}
        assert not fives, f"fleet served 5xx during backend loss: {codes}"
        # Byte-equality through the recovered fleet, incl. the victim.
        docs = _fetch_all(base, coords,
                          {"codes": {}, "saw_degraded": False})
        server.shutdown()
        server.server_close()
    finally:
        stop.set()
        sup.stop()
        obs.set_event_log(None)
        ev_log.close()
    base_docs = ctx["base_docs"]
    assert sorted(docs) == sorted(base_docs), (
        f"fleet tile set diverged: {len(docs)} vs {len(base_docs)}")
    mism = [k for k in docs if docs[k] != base_docs[k]]
    assert not mism, f"{len(mism)} fleet tiles diverged, e.g. {mism[:3]}"
    events = [json.loads(line) for line in open(events_path)]
    downs = [e for e in events if e["event"] == "fleet_backend_down"
             and e["backend"] == victim]
    ups = [e for e in events if e["event"] == "fleet_backend_up"
           and e["backend"] == victim]
    assert downs, f"no fleet_backend_down for {victim}: {events}"
    assert ups, f"no fleet_backend_up for {victim}: {events}"
    return {"victim": victim, "codes": {str(k): v for k, v in codes.items()},
            "tiles": len(docs), "down_events": len(downs),
            "up_events": len(ups)}


def phase_synopsis(ctx):
    """Wavelet-synopsis chaos: serve coarse tiles from synopses, tear
    one artifact plus a crashed staging tmp, and require the recovery
    sweep to quarantine both while serving falls back to exact bytes
    for the torn level — other levels keep their synopses, and no
    request ever sees a 500."""
    from heatmap_tpu_torch.delta.recover import sweep
    from heatmap_tpu_torch.io import open_sink
    from heatmap_tpu_torch.synopsis.build import synopsis_path

    faults.install(None)
    root = os.path.join(os.path.dirname(ctx["base_root"]),
                        "store-synopsis")
    bdir = os.path.join(root, "base-000001")
    cfg = BatchJobConfig(detail_zoom=10, min_detail_zoom=6,
                         result_delta=2)
    with open_sink(f"arrays-synopsis:{bdir}") as sink:
        run_job(SyntheticSource(ctx["n"], seed=5), sink, cfg,
                device=ctx["device"])
    with open(os.path.join(root, "CURRENT"), "w") as f:
        json.dump({"schema": "heatmap-tpu.delta_store.v1",
                   "base": "base-000001", "applied_through": 1,
                   "config": None}, f)
    store = TileStore(f"delta:{root}")
    app = ServeApp(store)
    layer = store.layer("default")
    delta_z = layer.result_delta
    syn_zooms = sorted(layer.synopses)
    assert len(syn_zooms) >= 2, f"need >=2 synopsized levels: {syn_zooms}"

    def busy_path(src):
        level = layer.levels[src]
        code = level.codes[int(np.argmax(level.values)):][:1]
        row, col = morton_decode_np(code)
        z = src - delta_z
        shift = delta_z  # source cells per tile axis = 2**delta
        return (f"/tiles/default/{z}/{int(col[0]) >> shift}"
                f"/{int(row[0]) >> shift}.json")

    codes: dict = {}

    def fetch(path):
        res = app.handle("GET", path)
        codes[res[0]] = codes.get(res[0], 0) + 1
        return res

    for src in syn_zooms:
        syn = fetch(busy_path(src) + "?synopsis=1")
        assert syn[0] == 200 and syn.headers is not None, \
            f"z{src} synopsis tile not annotated: {syn[0]}"
        assert fetch(busy_path(src))[0] == 200

    # Tear the middle artifact + leave a crashed staging file behind.
    victim = syn_zooms[len(syn_zooms) // 2]
    with open(synopsis_path(bdir, victim), "wb") as f:
        f.write(b"torn mid-write")
    with open(os.path.join(bdir, "synopsis-z99.npz.tmp"), "wb") as f:
        f.write(b"crashed staging")
    swept = sweep(root)
    reasons = sorted(i["reason"] for i in swept["quarantined"])
    assert reasons == ["orphan_tmp", "torn_synopsis"], reasons
    store.reload()
    layer = store.layer("default")
    assert victim not in layer.synopses, "torn synopsis still indexed"

    # The torn level falls back to exact bytes (no annotation) ...
    fallback = fetch(busy_path(victim) + "?synopsis=1")
    exact = fetch(busy_path(victim))
    assert fallback[0] == 200 and getattr(fallback, "headers", None) is None
    assert fallback[2] == exact[2], "fallback diverged from exact bytes"
    # ... while the surviving levels keep serving synopses.
    survivor = fetch(busy_path(syn_zooms[0]) + "?synopsis=1")
    assert survivor[0] == 200 and survivor.headers is not None
    assert codes.get(500, 0) == 0, f"500s observed: {codes}"
    return {"synopsis_zooms": syn_zooms, "torn_zoom": victim,
            "quarantined": reasons,
            "codes": {str(k): v for k, v in sorted(codes.items())}}


def phase_query(ctx):
    """Range-query chaos: tear one integral-histogram artifact plus a
    crashed staging tmp, and require the recovery sweep to quarantine
    both while /query falls through to the exact level rows for the
    torn zoom — answers identical to the integral path modulo the
    ``path`` marker, sums pinned to an independent brute force, other
    zooms keep their integrals, and no request ever sees a 500."""
    from heatmap_tpu_torch.analytics.integral import integral_path
    from heatmap_tpu_torch.analytics.query import level_cells
    from heatmap_tpu_torch.delta.recover import sweep
    from heatmap_tpu_torch.io import open_sink

    faults.install(None)
    root = os.path.join(os.path.dirname(ctx["base_root"]), "store-query")
    bdir = os.path.join(root, "base-000001")
    cfg = BatchJobConfig(detail_zoom=10, min_detail_zoom=6,
                         result_delta=2)
    with open_sink(f"arrays-integral:{bdir}") as sink:
        run_job(SyntheticSource(ctx["n"], seed=5), sink, cfg,
                device=ctx["device"])
    with open(os.path.join(root, "CURRENT"), "w") as f:
        json.dump({"schema": "heatmap-tpu.delta_store.v1",
                   "base": "base-000001", "applied_through": 1,
                   "config": None}, f)
    store = TileStore(f"delta:{root}")
    app = ServeApp(store)
    layer = store.layer("default")
    int_zooms = sorted(layer.integrals)
    assert len(int_zooms) >= 2, f"need >=2 integral zooms: {int_zooms}"

    codes: dict = {}

    def fetch(path):
        res = app.handle("GET", path)
        codes[res[0]] = codes.get(res[0], 0) + 1
        return res

    def queries(z):
        n = 1 << z
        rects = [(0, 0, n - 1, n - 1)]
        level = layer.levels[z]
        row, col = (int(v[0]) for v in morton_decode_np(
            level.codes[int(np.argmax(level.values)):][:1]))
        rects.append((max(0, row - 40), max(0, col - 40),
                      min(n - 1, row + 40), min(n - 1, col + 40)))
        out = []
        for r0, c0, r1, c1 in rects:
            base = f"/query?layer=default&z={z}&bbox={c0},{r0},{c1},{r1}"
            out += [f"{base}&op=sum", f"{base}&op=topk&k=5",
                    f"{base}&op=quantile&q=0.5"]
        return out

    def answers(z):
        docs = {}
        for path in queries(z):
            res = fetch(path)
            assert res[0] == 200, f"query failed {res[0]}: {path}"
            docs[path] = json.loads(res[2])
        return docs

    before = {z: answers(z) for z in int_zooms}
    for z, docs in before.items():
        assert all(d["path"] == "integral" for d in docs.values()), docs

    # Tear the middle artifact + leave a crashed staging file behind.
    victim = int_zooms[len(int_zooms) // 2]
    with open(integral_path(bdir, victim), "wb") as f:
        f.write(b"torn mid-write")
    with open(os.path.join(bdir, "integral-z99.npz.tmp"), "wb") as f:
        f.write(b"crashed staging")
    swept = sweep(root)
    reasons = sorted(i["reason"] for i in swept["quarantined"])
    assert reasons == ["orphan_tmp", "torn_integral"], reasons
    kinds = sorted(i["kind"] for i in swept["quarantined"])
    assert kinds == ["integral", "integral"], kinds
    store.reload()
    layer = store.layer("default")
    assert victim not in layer.integrals, "torn integral still indexed"

    # The torn zoom falls through to exact rows with identical answers
    # ... while the surviving zooms keep their integral fast path.
    for z in int_zooms:
        want_path = "fallback" if z == victim else "integral"
        for url, doc in answers(z).items():
            assert doc["path"] == want_path, (url, doc)
            was = dict(before[z][url], path=want_path)
            assert doc == was, f"answers diverged after tear: {url}"
            if doc["op"] == "sum":  # independent brute-force pin
                c0, r0, c1, r1 = doc["bbox"]
                _, _, vals = level_cells(layer.levels[z],
                                         (r0, c0, r1, c1))
                assert doc["sum"] == float(vals.sum()), url
    assert codes.get(500, 0) == 0, f"500s observed: {codes}"
    return {"integral_zooms": int_zooms, "torn_zoom": victim,
            "quarantined": reasons,
            "codes": {str(k): v for k, v in sorted(codes.items())}}


def phase_temporal(ctx):
    """Temporal-plane chaos (docs/temporal.md): a bucketed store under
    serve, one bucket torn mid-serve. Warmed temporal tiles must keep
    answering with their last-good bytes (stale-if-error), the
    recovery sweep must quarantine exactly the torn bucket, the
    all-time tiles must stay byte-identical to their pre-tear
    responses (the plain path never reads buckets), and no request
    may see a 5xx."""
    from heatmap_tpu_torch.delta.compact import read_current
    from heatmap_tpu_torch.delta.recover import sweep
    from heatmap_tpu_torch.temporal import buckets as tb
    from heatmap_tpu_torch.temporal import fold as tfold

    faults.install(None)
    root = os.path.join(os.path.dirname(ctx["base_root"]),
                        "store-temporal")
    os.makedirs(root)
    tfold.ensure_config(root, width=100.0, fanout=2, keep=2, tiers=3)
    cfg = BatchJobConfig(detail_zoom=8, min_detail_zoom=2,
                         result_delta=2)
    rng = np.random.default_rng(23)
    for t0 in (1000.0, 1150.0, 1300.0, 1450.0):
        n = 60
        delta.apply_batch(root, delta.ColumnsSource({
            "latitude": rng.uniform(30.0, 50.0, n),
            "longitude": rng.uniform(-120.0, -70.0, n),
            "user_id": ["u%d" % (j % 3) for j in range(n)],
            "timestamp": [str(t0 + j) for j in range(n)],
        }), cfg, device=ctx["device"])
    delta.compact(root, retention=10)

    store = TileStore(f"delta:{root}")
    app = ServeApp(store, TileCache())
    codes: dict = {}

    def fetch(path):
        res = app.handle("GET", path)
        codes[res[0]] = codes.get(res[0], 0) + 1
        return res

    # Warm every z<=2 tile on three temporal cuts plus the plain path.
    before = {}
    for z in (1, 2):
        for x in range(1 << z):
            for y in range(1 << z):
                for q in ("", "?as_of=1200", "?window=150",
                          "?decay=100"):
                    p = f"/tiles/default/{z}/{x}/{y}.json{q}"
                    before[p] = fetch(p)
    warmed = [p for p, r in before.items()
              if r[0] == 200 and "as_of" in p]
    assert warmed, "no as_of tiles warmed — scenario too sparse"

    # Tear the oldest bucket mid-serve; the reload bumps the serving
    # generation so every warmed entry must re-render (and fail into
    # its last-good bytes).
    bdir = os.path.join(root, read_current(root)["base"],
                        tb.BUCKETS_DIRNAME)
    victim = sorted(os.listdir(bdir))[0]
    vdir = os.path.join(bdir, victim)
    level_files = [f for f in os.listdir(vdir) if f.endswith(".npz")]
    with open(os.path.join(vdir, level_files[0]), "wb") as f:
        f.write(b"torn mid-write")
    store.reload()

    stale = 0
    for p, was in before.items():
        if "?" in p and was[0] != 200:
            continue  # cold temporal miss: nothing last-good to keep
        res = fetch(p)
        assert res[0] == was[0] and res[2] == was[2], \
            f"bytes moved after tear: {p} ({was[0]} -> {res[0]})"
        if "?" in p and res[5] == "stale":
            stale += 1
    assert stale > 0, "no stale-if-error serves observed"

    swept = sweep(root)
    reasons = sorted(i["reason"] for i in swept["quarantined"])
    assert reasons == ["torn_bucket"], reasons
    assert not os.path.isdir(vdir), "torn bucket still in place"
    # The all-time path never noticed the quarantine either.
    for p, was in before.items():
        if "?" not in p:
            res = fetch(p)
            assert res[0] == was[0] and res[2] == was[2], p
    assert not any(c >= 500 for c in codes), f"5xx observed: {codes}"
    return {"torn_bucket": victim, "stale_serves": stale,
            "quarantined": reasons,
            "codes": {str(k): v for k, v in sorted(codes.items())}}


def phase_tilefs(ctx):
    """tilefs chaos (heatmap_tpu_torch.tilefs): a converted store serving
    zero-copy through the disk render cache while the fault plane fires
    on both new sites. Requirements: bytes identical to heap (npz)
    serving at every step — clean, with ``tilefs.read`` faults forcing
    per-zoom npz fallbacks mid-reload and ``diskcache.write`` faults
    skipping fills, after a torn disk-cache entry (reads as a miss that
    refills), and after a torn mirror + crashed staging tmp that the
    recovery sweep must quarantine — and no request ever sees a 500."""
    from heatmap_tpu_torch.delta.recover import sweep
    from heatmap_tpu_torch.io import open_sink
    from heatmap_tpu_torch.tilefs import DiskTileCache, sniff_tilefs
    from heatmap_tpu_torch.tilefs.diskcache import DISK_CACHE_TORN

    faults.install(None)
    obs.enable_metrics(True)  # the torn-entry check reads a counter
    root = os.path.join(os.path.dirname(ctx["base_root"]), "store-tilefs")
    bdir = os.path.join(root, "base-000001")
    cfg = BatchJobConfig(detail_zoom=10, min_detail_zoom=6,
                         result_delta=2)
    with open_sink(f"arrays-tilefs:{bdir}") as sink:
        run_job(SyntheticSource(ctx["n"], seed=5), sink, cfg,
                device=ctx["device"])
    with open(os.path.join(root, "CURRENT"), "w") as f:
        json.dump({"schema": "heatmap-tpu.delta_store.v1",
                   "base": "base-000001", "applied_through": 1,
                   "config": None}, f)
    assert sniff_tilefs(bdir), "arrays-tilefs sink left no mirrors"

    # Heap truth: the same base read through the explicit arrays kind
    # (npz only — the bare path would sniff the mirrors right back).
    heap_app = ServeApp(TileStore(f"arrays:{bdir}"), TileCache())
    store = TileStore(root)  # bare path sniffs the tilefs kind
    assert store.stats()["kind"] == "tilefs", store.stats()
    disk_root = os.path.join(root, "diskcache")
    app = ServeApp(store, TileCache(),
                   disk_cache=DiskTileCache(disk_root))

    layer = store.layer("default")
    dz = layer.result_delta
    paths = []
    for d in sorted(layer.detail_zooms):
        z = d - dz
        if z < 0:
            continue
        coarse = np.unique(layer.levels[d].codes >> np.int64(2 * dz))
        rows, cols = morton_decode_np(coarse)
        paths += [f"/tiles/default/{z}/{int(c)}/{int(r)}.{fmt}"
                  for r, c in zip(rows, cols)
                  for fmt in ("json", "png")]
    paths = paths[:48]

    codes: dict = {}

    def identical(note):
        for p in paths:
            a = heap_app.handle("GET", p)
            b = app.handle("GET", p)
            codes[b[0]] = codes.get(b[0], 0) + 1
            assert a[0] == b[0] == 200, (note, p, a[0], b[0])
            assert a[2] == b[2], (note, "bytes diverged", p)

    # 1. Clean pass: mmap'd serving matches heap, disk tier fills.
    identical("clean")
    assert app.disk_cache.stats()["entries"] > 0, "disk tier never filled"

    # 2. Torn disk-cache entry: truncate one published entry, drop the
    #    heap cache so the disk tier is actually consulted — the torn
    #    entry must read as a miss (unlinked + refilled), never bytes.
    victims = [os.path.join(dp, fn) for dp, _dirs, fns
               in os.walk(disk_root) for fn in fns
               if not fn.startswith(".tmp-")]
    with open(victims[0], "r+b") as f:
        f.truncate(7)
    torn0 = DISK_CACHE_TORN.value()
    app.cache.clear()
    identical("after torn disk-cache entry")
    assert DISK_CACHE_TORN.value() > torn0, "torn entry never detected"
    # ... and the refill re-published a whole entry under the same key.
    assert os.path.getsize(victims[0]) > 7, "torn entry never refilled"

    # 3. Fault plane on both new sites: tilefs.read fires during the
    #    reload's per-zoom opens (retries=0 by policy — each faulted
    #    zoom must fall back to its sibling npz level), diskcache.write
    #    fires on the refills (a skipped fill, never an error).
    faults.install_spec(
        "seed=17,scale=0,tilefs.read=3x2,diskcache.write=6x2")
    try:
        store.reload()
        app.cache.clear()
        identical("under fault plane (mixed mmap/npz zooms)")
    finally:
        faults.install(None)
    store.reload()
    identical("recovered (all zooms mapped again)")

    # 4. Torn mirror + crashed staging tmp: the sweep quarantines both,
    #    and the reloaded store serves the torn zoom from npz.
    mirrors = sorted(n for n in os.listdir(bdir)
                     if n.startswith("tilefs-z") and n.endswith(".bin"))
    victim = mirrors[len(mirrors) // 2]
    with open(os.path.join(bdir, victim), "r+b") as f:
        f.write(b"torn mid-write")
    with open(os.path.join(bdir, "tilefs-z99.bin.tmp"), "wb") as f:
        f.write(b"crashed staging")
    swept = sweep(root)
    reasons = sorted(i["reason"] for i in swept["quarantined"])
    assert reasons == ["orphan_tmp", "torn_tilefs"], reasons
    kinds = sorted(i["kind"] for i in swept["quarantined"])
    assert kinds == ["tilefs", "tilefs"], kinds
    store.reload()
    identical("after torn mirror (npz fallback)")

    assert codes.get(500, 0) == 0, f"500s observed: {codes}"
    return {"paths": len(paths), "torn_mirror": victim,
            "quarantined": reasons,
            "disk_cache": app.disk_cache.stats(),
            "codes": {str(k): v for k, v in sorted(codes.items())}}


def phase_incident(ctx):
    """Flight-recorder incident discipline under a seeded fault storm:
    12 injected ``tile.render`` faults inside request-shaped shadow
    spans (head sampling at 0.0) form exactly three storm episodes at
    threshold 4 — the first flushes exactly ONE bundle, the rate limit
    suppresses the other two — and the bundle replays as a valid
    Perfetto trace (``_replay``) holding the request trees
    completed before the flush. Every faulted tree is tail-promoted
    into the collector as if head-sampled, and the request histogram
    carries a promoted trace's id as its /metrics exemplar."""
    from heatmap_tpu_torch.obs import incident as incident_mod
    from heatmap_tpu_torch.obs import recorder as recorder_mod
    from heatmap_tpu_torch.obs import tracing
    from heatmap_tpu_torch.obs.incident import IncidentManager
    from heatmap_tpu_torch.obs.recorder import FlightRecorder

    inc_dir = ctx.get("incident_dir") or os.path.join(
        os.path.dirname(ctx["base_root"]), "incidents")
    n_faults, threshold = 12, 4
    obs.enable_metrics(True)
    collector = tracing.enable_tracing(sample=0.0)
    recorder_mod.install(FlightRecorder(max_spans=256))
    mgr = IncidentManager(inc_dir, run_id="soak",
                          storm_threshold=threshold,
                          storm_window_s=3600.0, min_interval_s=3600.0)
    incident_mod.set_manager(mgr)
    incident_mod.add_state_provider(
        "soak", lambda: {"phase": "incident", "n_faults": n_faults})
    reg = obs.get_registry()
    hist = reg.histogram("soak_request_seconds", buckets=(0.001, 10.0))
    plane = faults.install_spec(f"seed=17,scale=0,tile.render={n_faults}")
    try:
        for i in range(n_faults):
            req = tracing.begin_span("serve.request", {"tile": i})
            render = tracing.begin_span("tile.render")
            try:
                faults.check("tile.render", key=i)
            except faults.InjectedFault:
                pass  # the fault event itself promotes the tree
            tracing.end_span(render)
            hist.observe(0.0005)
            tracing.end_span(req)
        assert plane.injected == n_faults, plane.counts()

        # Exactly one bundle: episodes 2 and 3 hit the rate limit.
        assert len(mgr.flushed) == 1, mgr.flushed
        assert mgr.suppressed == 2, mgr.suppressed
        assert obs.INCIDENTS_TOTAL.value(trigger="fault_storm") == 1
        bundles = [d for d in os.listdir(inc_dir)
                   if not d.startswith(".tmp-")]
        assert bundles == ["soak-0"], bundles

        # The bundle replays as a valid Perfetto trace: the request
        # trees completed before the 4th fault flushed it.
        replay = _replay(mgr.flushed[0])
        assert replay["n_spans"] == 2 * (threshold - 1), replay["n_spans"]
        for row in replay["traces"]:
            assert row["root"] == "serve.request" and not row["partial"]
            assert row["critical_path"] == ["serve.request", "tile.render"]
        manifest = json.load(open(os.path.join(mgr.flushed[0],
                                               "manifest.json")))
        assert manifest["trigger"] == "fault_storm"
        state = json.load(open(os.path.join(mgr.flushed[0], "state.json")))
        assert state["soak"]["n_faults"] == n_faults

        # Tail promotion: every faulted (unsampled) tree reached the
        # collector as if head-sampled.
        promoted = {r["trace_id"] for r in collector.spans()}
        assert len(promoted) == n_faults, len(promoted)
        rcd_stats = recorder_mod.get_recorder().stats()
        assert rcd_stats["promoted_traces"] == n_faults

        # Exemplar tie-in: the histogram bucket names a promoted trace.
        prom = reg.render_prometheus()
        [line] = [l for l in prom.splitlines() if l.startswith(
            'soak_request_seconds_bucket{le="0.001"}')]
        exemplar_tid = line.split('trace_id="')[1].split('"')[0]
        assert exemplar_tid in promoted
        return {"bundles": len(bundles), "suppressed": mgr.suppressed,
                "replay_spans": replay["n_spans"],
                "promoted_traces": len(promoted),
                "bundle_bytes": manifest["bytes"],
                "incident_dir": inc_dir}
    finally:
        faults.install(None)
        incident_mod.set_manager(None)
        recorder_mod.install(None)
        tracing.disable_tracing()
        reg.reset()
        obs.enable_metrics(False)


def phase_telemetry(ctx):
    """Telemetry pipeline chaos under a fake clock: a scripted lag
    spike through the real sampler must fire exactly ONE anomaly edge
    and flush exactly one anomaly-triggered incident bundle with the
    surrounding raw-tier history embedded; the telemetry surface
    (``/series`` fleet-merged, ``/dashboard``, ``/healthz``) answers
    every request with zero 5xx while the sampler keeps ticking; and a
    torn telemetry spill snapshot (simulated crash mid-write plus an
    orphaned publish tmp dir) is quarantined on re-arm — never a crash,
    never blocking the next spill."""
    from heatmap_tpu_torch.obs import anomaly as anomaly_mod
    from heatmap_tpu_torch.obs import incident as incident_mod
    from heatmap_tpu_torch.obs import timeseries
    from heatmap_tpu_torch.obs.anomaly import AnomalyEngine, parse_watch_spec
    from heatmap_tpu_torch.obs.incident import IncidentManager
    from heatmap_tpu_torch.obs.timeseries import TelemetrySampler, TimeSeriesStore
    from heatmap_tpu_torch.serve.router import RouterApp

    scratch = os.path.dirname(ctx["base_root"])
    tel_dir = os.path.join(scratch, "telemetry")
    inc_dir = os.path.join(scratch, "incidents-telemetry")
    clock = {"t": 1_000_000.0}

    def now():
        return clock["t"]

    obs.enable_metrics(True)
    reg = obs.get_registry()
    lag = reg.gauge("soak_lag_seconds")
    engine = AnomalyEngine(
        [parse_watch_spec("soak_lag_seconds:z=5,min_count=8")], clock=now)
    anomaly_mod.set_engine(engine)
    store = TimeSeriesStore(spill_dir=tel_dir, clock=now)
    timeseries.install(store)
    sampler = TelemetrySampler(store, 10.0, registry=reg, engine=engine,
                               clock=now, spill_every_ticks=4)
    mgr = IncidentManager(inc_dir, run_id="tel", min_interval_s=3600.0,
                          clock=now)
    incident_mod.set_manager(mgr)
    try:
        # Scripted baseline, then a sustained spike: one rising edge,
        # not one per breaching tick.
        for i in range(30):
            clock["t"] += 10.0
            lag.set(1.0 + (i % 4) * 0.02)
            sampler.sample_once(clock["t"])
        for _ in range(6):
            clock["t"] += 10.0
            lag.set(40.0)
            sampler.sample_once(clock["t"])
        assert engine.status()["edges"] == 1, engine.status()
        bundles = [d for d in os.listdir(inc_dir)
                   if not d.startswith(".tmp-")]
        assert len(bundles) == 1, bundles
        manifest = json.load(open(os.path.join(inc_dir, bundles[0],
                                               "manifest.json")))
        assert manifest["trigger"] == "anomaly", manifest
        tel = json.load(open(os.path.join(inc_dir, bundles[0],
                                          "telemetry.json")))
        pts = tel["series"]["soak_lag_seconds"]["points"]
        assert pts, "bundle must embed the pre-trigger history"
        assert max(p[5] for p in pts) == 40.0
        assert min(p[5] for p in pts) < 2.0  # baseline is in the window

        # Zero 5xx on the telemetry surface while sampling continues —
        # through the fleet router, the strictest path (local parse +
        # fleet merge + dashboard shell).
        router = RouterApp([])
        statuses = set()
        for _ in range(20):
            clock["t"] += 10.0
            sampler.sample_once(clock["t"])
            for path in ("/series?name=soak_lag_seconds&fleet=1",
                         "/dashboard", "/healthz"):
                statuses.add(router.handle("GET", path)[0])
        assert statuses == {200}, statuses
        doc = json.loads(router.handle(
            "GET", "/series?name=soak_lag_seconds")[2])
        assert doc["enabled"] and doc["frames"], doc

        # Torn spill: corrupt the newest snapshot and plant an orphaned
        # publish tmp dir; re-arming quarantines both and restores the
        # newest intact snapshot without raising.
        store.spill()
        snaps = sorted(d for d in os.listdir(tel_dir)
                       if d.startswith("snap-"))
        with open(os.path.join(tel_dir, snaps[-1], "series.json"),
                  "w") as f:
            f.write('{"torn')
        os.makedirs(os.path.join(tel_dir, ".tmp-snap-crash"),
                    exist_ok=True)
        fresh = TimeSeriesStore(spill_dir=tel_dir, clock=now)
        fresh.load_spill()  # must not raise
        qdir = os.path.join(tel_dir, "quarantine")
        assert os.path.isdir(qdir), "torn spill was not quarantined"
        quarantined = len(os.listdir(qdir))
        assert quarantined >= 2, os.listdir(qdir)
        clock["t"] += 10.0
        fresh.observe("soak_lag_seconds", 1.0, ts=clock["t"])
        fresh.spill()  # quarantine never blocks the next spill
        return {"bundles": len(bundles), "edges": 1,
                "statuses": sorted(statuses), "quarantined": quarantined,
                "restored_series": fresh.stats()["series"]}
    finally:
        incident_mod.set_manager(None)
        anomaly_mod.set_engine(None)
        timeseries.install(None)
        obs.enable_metrics(False)


def phase_adaptive(ctx):
    """Brownout-ladder chaos: one overload episode under a fake clock
    and a scripted burn schedule must walk the ladder up 0->1->2->3
    and back down to 0, with the rungs' serving policies observable at
    each plateau (synopsis stamps, the raised ceiling, deterministic
    brownout sheds), zero 500s, identical status/rung traces across a
    repeat run, and — once recovered to rung 0 — bytes and ETags
    identical to a controller-less server."""
    from heatmap_tpu_torch.io import open_sink
    from heatmap_tpu_torch.serve import degrade

    faults.install(None)
    scratch = os.path.dirname(ctx["base_root"])
    root = os.path.join(scratch, "store-adaptive")
    cfg = BatchJobConfig(detail_zoom=10, min_detail_zoom=6,
                         result_delta=2)
    with open_sink(f"arrays-synopsis:{root}") as sink:
        run_job(SyntheticSource(ctx["n"], seed=9), sink, cfg,
                device=ctx["device"])
    store = TileStore(f"arrays:{root}")
    layer = store.layer("default")
    syn_zooms = sorted(layer.synopses)  # sources 7/8/9 under cfg
    delta_z = layer.result_delta

    def busy_path(src):
        level = layer.levels[src]
        code = level.codes[int(np.argmax(level.values)):][:1]
        row, col = morton_decode_np(code)
        z = src - delta_z
        return (f"/tiles/default/{z}/{int(col[0]) >> delta_z}"
                f"/{int(row[0]) >> delta_z}.json")

    # Fixed request mix: every synopsis-backed coarse zoom, one deep
    # zoom with NO natural synopsis (the rung-2 ceiling target), and a
    # spread of neighbors so the rung-3 fractional shed has keys to
    # split. Deterministic by construction.
    deep_src = max(layer.detail_zooms)
    assert deep_src not in layer.synopses
    paths = [busy_path(src) for src in syn_zooms + [deep_src]]
    bx, by = paths[0].split("/")[4:6]
    z0 = int(paths[0].split("/")[3])
    for dx in range(4):
        for dy in range(3):
            x = (int(bx) + dx) % (1 << z0)
            y = (int(by.split(".")[0]) + dy) % (1 << z0)
            paths.append(f"/tiles/default/{z0}/{x}/{y}.json")
    # Burn schedule: hot long enough for three 2s dwells, then cool
    # through three 3s holds — one full staircase per episode.
    schedule = [(float(t), 2.5) for t in range(9)]
    schedule += [(float(t), 0.1) for t in range(9, 22)]

    def episode(run_idx):
        tnow, burn = [0.0], [0.0]
        ctl = degrade.BrownoutController(
            dwell_s=2.0, hold_s=3.0, poll_interval_s=0.0,
            shed_fraction=0.5,
            burn_source=lambda: {"tiles-fast": burn[0]},
            clock=lambda: tnow[0])
        app = ServeApp(store, TileCache(), max_inflight=8, degrade=ctl)
        ev_path = os.path.join(scratch, f"adaptive-{run_idx}.jsonl")
        log = obs.EventLog(ev_path, run_id=f"adaptive-{run_idx}")
        obs.set_event_log(log)
        trace, codes, stamped, sheds = [], {}, 0, 0
        try:
            faults.install(faults.FaultPlane(seed=11))
            for t, b in schedule:
                tnow[0], burn[0] = t, b
                for path in paths:
                    res = app.handle("GET", path)
                    codes[res[0]] = codes.get(res[0], 0) + 1
                    if res[0] == 503:
                        sheds += 1
                        assert json.loads(res[2])["cause"] == "brownout"
                        assert ctl.rung == ctl.max_rung, \
                            f"shed below top rung at t={t}"
                    elif getattr(res, "headers", None) is not None:
                        stamped += 1
                        assert ctl.rung >= 1, f"stamp at rung 0, t={t}"
                    trace.append((t, path, res[0], ctl.rung))
        finally:
            faults.install(None)
            obs.set_event_log(None)
            log.close()
        steps = [(r["rung"], r["direction"], r["cause"])
                 for r in obs.read_events(ev_path)
                 if r["event"] == "degrade_step"]
        return app, trace, codes, steps, stamped, sheds

    app1, trace1, codes1, steps1, stamped1, sheds1 = episode(1)
    _, trace2, codes2, steps2, _, _ = episode(2)

    # One clean staircase, edge-triggered: exactly three ups with the
    # burning objective as cause, three recovery downs, nothing else.
    assert steps1 == [(1, "up", "tiles-fast"), (2, "up", "tiles-fast"),
                      (3, "up", "tiles-fast"), (2, "down", "recovery"),
                      (1, "down", "recovery"),
                      (0, "down", "recovery")], steps1
    # Deterministic ladder: the repeat run reproduces every status and
    # every rung at every tick, not just the final shape.
    assert steps2 == steps1
    assert trace2 == trace1
    assert codes1 == codes2
    assert codes1.get(500, 0) == 0, f"500s observed: {codes1}"
    assert sheds1 > 0, "top rung never shed"
    assert stamped1 > 0, "no synopsis-stamped responses"
    # The stretch rung actually raised the ceiling for the deep zoom.
    deep = paths[len(syn_zooms)]
    stretch_hits = [s for (t, p, s, rung) in trace1
                    if p == deep and rung == 2]
    assert stretch_hits and all(s == 200 for s in stretch_hits)

    # Recovered at rung 0: body AND ETag byte-identical to a server
    # that never had a controller, for every path in the mix.
    bare = ServeApp(store, TileCache())
    assert app1.degrade.rung == 0
    for path in paths:
        a, b = bare.handle("GET", path), app1.handle("GET", path)
        assert tuple(a)[:4] == tuple(b)[:4], path
        assert (getattr(a, "headers", None)
                == getattr(b, "headers", None)), path
    return {"steps": [f"{d}->{r}" for r, d, _ in steps1],
            "requests": sum(codes1.values()),
            "codes": {str(k): v for k, v in sorted(codes1.items())},
            "synopsis_stamped": stamped1, "shed": sheds1}


PHASES = [
    ("baseline", phase_baseline),
    ("chaos_pipeline", phase_chaos_pipeline),
    ("chaos_serve", phase_chaos_serve),
    ("heartbeat", phase_heartbeat),
    ("fault_floor", phase_fault_floor),
    ("ingest_crash", phase_ingest_crash),
    ("writer_loss", phase_writer_loss),
    ("dispatch", phase_dispatch),
    ("host_loss", phase_host_loss),
    ("host_loss_morton", phase_host_loss_morton),
    ("backend_loss", phase_backend_loss),
    ("synopsis", phase_synopsis),
    ("query", phase_query),
    ("temporal", phase_temporal),
    ("tilefs", phase_tilefs),
    ("incident", phase_incident),
    ("telemetry", phase_telemetry),
    ("adaptive", phase_adaptive),
    ("byte_equality", phase_byte_equality),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.chaos_soak",
        description="pipeline chaos soak: byte-equality under "
                    "deterministic fault injection")
    ap.add_argument("--n", type=int, default=3000,
                    help="synthetic points for the ingest run")
    ap.add_argument("--chaos", default=DEFAULT_CHAOS,
                    help="fault-plane spec (see docs/robustness.md)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch directory")
    ap.add_argument("--only", action="append", default=None,
                    help="run only the named phase(s); byte_equality "
                         "needs the earlier ones")
    ap.add_argument("--incident-dir", default=None, metavar="DIR",
                    help="where the incident phase flushes its bundles "
                         "(default: the scratch dir)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.tools._common import device_fields

    device = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="chaos-soak-")
    ctx = {
        "n": args.n, "chaos": args.chaos, "device": device,
        "base_root": os.path.join(tmp, "store-base"),
        "chaos_root": os.path.join(tmp, "store-chaos"),
        "base_arrays": os.path.join(tmp, "arrays-base"),
        "chaos_arrays": os.path.join(tmp, "arrays-chaos"),
        "incident_dir": args.incident_dir,
    }
    failed = 0
    try:
        for name, fn in PHASES:
            if args.only and name not in args.only:
                continue
            t0 = time.monotonic()
            try:
                info = fn(ctx)
                print(json.dumps({"phase": name, "ok": True,
                                  "seconds": round(time.monotonic() - t0, 1),
                                  **(info or {})}))
            except Exception as e:
                failed += 1
                traceback.print_exc()
                print(json.dumps({"phase": name, "ok": False,
                                  "seconds": round(time.monotonic() - t0, 1),
                                  "error": f"{type(e).__name__}: {e}"}))
            sys.stdout.flush()
    finally:
        faults.install(None)
        if args.keep:
            print(json.dumps({"scratch": tmp}))
        else:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"failed": failed, **device_fields(device)}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
