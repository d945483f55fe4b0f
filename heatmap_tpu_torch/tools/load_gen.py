"""Closed-loop load generator for the tile server.

The port's twin of ``tools/load_gen.py``. It runs the serving stack in
process (``ServeApp`` on an ephemeral-port ``ThreadingHTTPServer``, the
code path of ``heatmap_tpu_torch serve``) and drives it with
``--workers`` closed-loop client threads over a Zipf-skewed tile
universe taken from the store: each worker sends its next request only
after the previous one returns, so the measured requests/s are the
server's. A warm-up pass touches the working set, then the measured
window runs (its hit rate should exceed 0.95); then the flight recorder
and the telemetry sampler are each swept on and off.

Without ``--store`` it first builds a synthetic ``arrays:`` store with
``run_job`` on ``--device``; serving itself is host work. The record
carries the JAX tool's keys plus ``device``: where that job ran (and,
on a card, ``gpu_name`` and ``power_limit_w``), or ``host`` when
``--store`` is given and no job runs.

- ``--fleet N1,N2,...``: the same traffic through a router in front of
  N real backend processes (they open no CUDA context), from
  ``--drive-procs`` client processes that run this module with the
  hidden ``--drive``; then a kill-one-backend availability run.
- ``--adaptive``: the brownout bench (``serve/degrade.py``): an
  overload ramp against a small admission bound with the degradation
  ladder off and on; its record goes to ``--adaptive-out``.
- ``--cold-vs-warm``: the tilefs restart A/B (a fresh server with no
  warm tiers against one restarting over a filled ``DiskTileCache``
  with a ``PrewarmConfig`` replay of the hot head) and the fleet Pss
  probe (``mem_probe.measure_fleet_pss``, mapped against heap), merged
  into ``--out`` as ``cold_warm`` and ``fleet_rss``.

    python -m heatmap_tpu_torch.tools.load_gen [--store arrays:levels/]
        [--workers 8] [--duration 10] [--device cuda|cpu]
        [--out build/torch_bench/load_gen.json]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse

import numpy as np

from heatmap_tpu_torch.tools._common import (HOST_FIELDS, default_out,
                                             device_fields, write_record)

#: The JAX tool's closed-loop record keys (``fleet`` only with
#: ``--fleet``).
RECORD_KEYS = ("bench", "store", "workers", "tiles", "warmup_s",
               "duration_s", "requests", "errors", "statuses", "rps",
               "latency_ms", "hit_rate", "cache", "obs", "run_report")


def synth_store(tmpdir: str, n_points: int, *, sink: str = "arrays",
                config=None, device="cuda") -> str:
    """Run the batch job on ``device`` over synthetic points into
    ``arrays`` egress (``--adaptive`` asks for ``arrays-synopsis`` and a
    synopsis-bearing config, so rung 1 has something to serve)."""
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job

    path = os.path.join(tmpdir, "levels")
    config = config or BatchJobConfig(detail_zoom=12, min_detail_zoom=5)
    with open_sink(f"{sink}:{path}") as out:
        run_job(open_source(f"synthetic:{n_points}"), out, config,
                device=device)
    return f"arrays:{path}"


def tile_universe(store, max_tiles: int, seed: int = 0) -> list:
    """(layer, z, x, y, fmt) population: every blob-bearing coarse tile
    of the default layer (fallback: first layer), both formats."""
    from heatmap_tpu_torch.tilemath.morton import morton_decode_np

    name = "default" if store.layer("default") else store.layer_names()[0]
    layer = store.layer(name)
    delta = layer.result_delta
    tiles = []
    for d in layer.detail_zooms:
        z = d - delta
        if z < 0:
            continue
        coarse = np.unique(layer.levels[d].codes >> np.int64(2 * delta))
        rows, cols = morton_decode_np(coarse)
        tiles += [(name, z, int(c), int(r), fmt)
                  for r, c in zip(rows, cols)
                  for fmt in ("json", "png")]
    random.Random(seed).shuffle(tiles)
    return tiles[:max_tiles]


class Worker(threading.Thread):
    """One closed-loop client: Zipf-ish sampling over the universe,
    keep-alive connection, per-request wall latency."""

    def __init__(self, host, port, universe, stop_at, seed):
        super().__init__(daemon=True)
        self.host, self.port = host, port
        self.universe = universe
        self.stop_at = stop_at
        self.rng = random.Random(seed)
        self.latencies_ms: list = []
        self.statuses: dict = {}
        self.errors = 0
        # Fidelity accounting for the adaptive (brownout) bench: how
        # many answers were synopsis-stamped, the worst stamped error,
        # and the typed causes behind any 503s.
        self.synopsis = 0
        self.max_err = 0.0
        self.causes: dict = {}

    def _pick(self):
        # 80% of traffic on the first 20% of the (shuffled) universe —
        # the hot-set skew a map viewport produces.
        n = len(self.universe)
        if self.rng.random() < 0.8:
            return self.universe[self.rng.randrange(max(1, n // 5))]
        return self.universe[self.rng.randrange(n)]

    def run(self):
        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        while time.monotonic() < self.stop_at:
            layer, z, x, y, fmt = self._pick()
            t0 = time.monotonic()
            try:
                conn.request("GET", f"/tiles/{layer}/{z}/{x}/{y}.{fmt}")
                resp = conn.getresponse()
                body = resp.read()
                status = resp.status
                marker = resp.getheader("X-Heatmap-Synopsis")
            except Exception:
                self.errors += 1
                conn.close()
                conn = http.client.HTTPConnection(self.host, self.port,
                                                  timeout=30)
                continue
            self.latencies_ms.append((time.monotonic() - t0) * 1e3)
            self.statuses[status] = self.statuses.get(status, 0) + 1
            if marker is not None:
                self.synopsis += 1
                try:
                    err = float(marker.split("max_err=")[1].split(";")[0])
                except (IndexError, ValueError):
                    pass
                else:
                    self.max_err = max(self.max_err, err)
            if status == 503:
                try:
                    cause = json.loads(body).get("cause")
                except (ValueError, AttributeError):
                    cause = None
                if cause:
                    self.causes[cause] = self.causes.get(cause, 0) + 1
        conn.close()


def _drive(args) -> int:
    """``--drive URL`` mode: act as a pure load client against an
    already-running server (the fleet bench spawns several of these as
    subprocesses so the *client* is not capped by one GIL). Prints one
    JSON result line on stdout."""
    parsed = urllib.parse.urlsplit(args.drive)
    with open(args.universe_file) as f:
        universe = [tuple(t) for t in json.load(f)]
    stop_at = time.monotonic() + args.duration
    workers = [Worker(parsed.hostname, parsed.port, universe, stop_at,
                      seed=args.seed_base + i)
               for i in range(args.workers)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    statuses: dict = {}
    for w in workers:
        for s, c in w.statuses.items():
            statuses[str(s)] = statuses.get(str(s), 0) + c
    print(json.dumps({
        "latencies_ms": [round(v, 3) for w in workers
                         for v in w.latencies_ms],
        "statuses": statuses,
        "errors": int(sum(w.errors for w in workers)),
    }), flush=True)
    return 0


def _child_env() -> dict:
    """This process's environment with the port's checkout on the
    path, for the ``--drive`` client processes."""
    import heatmap_tpu_torch

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(heatmap_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _drive_clients(base_url: str, universe, duration: float, *,
                   workers: int, procs: int, tmpdir: str):
    """Fan the Zipf client out over ``procs`` subprocesses; returns
    (sorted latencies ms, statuses, errors)."""
    universe_file = os.path.join(tmpdir, "universe.json")
    with open(universe_file, "w") as f:
        json.dump([list(t) for t in universe], f)
    children = []
    for i in range(procs):
        children.append(subprocess.Popen(
            [sys.executable, "-m", "heatmap_tpu_torch.tools.load_gen",
             "--drive", base_url, "--universe-file", universe_file,
             "--duration", str(duration), "--workers", str(workers),
             "--seed-base", str(1000 * i)],
            stdout=subprocess.PIPE, text=True, env=_child_env()))
    latencies: list = []
    statuses: dict = {}
    errors = 0
    for child in children:
        out, _ = child.communicate(timeout=duration + 120)
        result = json.loads(out.strip().splitlines()[-1])
        latencies += result["latencies_ms"]
        errors += result["errors"]
        for s, c in result["statuses"].items():
            statuses[s] = statuses.get(s, 0) + c
    return np.sort(np.asarray(latencies)), statuses, errors


def _lat_summary(lat) -> dict:
    def pct(p):
        return round(float(lat[min(len(lat) - 1, int(p * len(lat)))]), 3) \
            if len(lat) else None

    return {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
            "max": round(float(lat[-1]), 3) if len(lat) else None}


def _warm(base_url: str, universe):
    parsed = urllib.parse.urlsplit(base_url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=30)
    for layer, z, x, y, fmt in universe:
        conn.request("GET", f"/tiles/{layer}/{z}/{x}/{y}.{fmt}")
        conn.getresponse().read()
    conn.close()


def _sweep_latencies(host, port, universe):
    """Sequential sweep with per-request wall ms (keep-alive); sorted.
    Unlike the closed-loop Worker this touches every tile exactly once,
    so a fresh server's sweep IS its first-touch (cold) distribution."""
    conn = http.client.HTTPConnection(host, port, timeout=30)
    out = []
    for layer, z, x, y, fmt in universe:
        t0 = time.perf_counter()
        conn.request("GET", f"/tiles/{layer}/{z}/{x}/{y}.{fmt}")
        conn.getresponse().read()
        out.append((time.perf_counter() - t0) * 1e3)
    conn.close()
    return np.sort(np.asarray(out))


def _write_request_log(path: str, universe, hot):
    """Synthesize the ``http_request`` event log the prewarm planner
    replays: one pass over the whole universe, then repeated passes
    over the hot head, so the planner's recency-decayed scores rank the
    head first — the same 80/20 shape the closed-loop Worker drives,
    but deterministic instead of sampled."""
    from heatmap_tpu_torch import obs

    with obs.EventLog(path) as log:
        for pass_set in (universe, hot, hot, hot):
            for layer, z, x, y, fmt in pass_set:
                log.emit("http_request", route="tiles",
                         path=f"/tiles/{layer}/{z}/{x}/{y}.{fmt}",
                         status=200, ms=1.0)


def _cold_warm_bench(args, tmpdir: str) -> dict:
    """``--cold-vs-warm``: the tilefs serving-tier A/B
    (heatmap_tpu_torch.tilefs) for the serve record. Three
    servers over the same mmap'd store:

    - cold: fresh process state, no disk tier, no prewarm — every
      request renders from the pyramid (the post-deploy worst case);
    - prep: sweeps the universe once through a disk cache to fill it,
      then is thrown away (a restart, as far as the tiers can tell);
    - warmed: fresh process state again, same disk cache root, prewarm
      replay of the hot head into the heap cache before the sweep.

    Both measured legs are sequential first-touch sweeps over the SAME
    universe, so warmed-vs-cold isolates exactly what the disk tier +
    prewarm buy across a restart. Also embeds the fleet Pss probe
    (``mem_probe``): N mapped backends vs N heap backends over
    the same store dir — sub-linear fleet memory is the mmap story's
    other half.
    """
    from heatmap_tpu_torch.serve import (ServeApp, TileCache, TileStore,
                                   serve_in_thread)
    from heatmap_tpu_torch.tilefs import DiskTileCache, PrewarmConfig

    # Two views of one artifact: the arrays-tilefs sink writes npz
    # levels AND tilefs mirrors into the same dir, so the heap and
    # mapped legs differ only in how they read it. A caller-supplied
    # --store must be an arrays:DIR whose dir carries tilefs mirrors
    # (``tilefs_convert`` adds them in place).
    heap_spec = args.store
    store_dir = heap_spec.split(":", 1)[1]
    mapped_spec = f"tilefs:{store_dir}"

    universe = tile_universe(TileStore(mapped_spec), args.tiles)
    if not universe:
        raise SystemExit("store has no blob-bearing tiles")
    hot = universe[:max(1, len(universe) // 5)]

    def leg(disk_cache=None, prewarm=None):
        app = ServeApp(TileStore(mapped_spec),
                       TileCache(max_bytes=args.cache_bytes),
                       disk_cache=disk_cache, prewarm=prewarm)
        server, _base = serve_in_thread(app)
        host, port = server.server_address[:2]
        summary = app.prewarm_now(source="startup") if prewarm else None
        lat = _sweep_latencies(host, port, universe)
        server.shutdown()
        server.server_close()
        return lat, summary, app

    cold_lat, _, _ = leg()

    disk_root = os.path.join(tmpdir, "diskcache")
    events = os.path.join(tmpdir, "prewarm-events.jsonl")
    _write_request_log(events, universe, hot)
    _prep_lat, _, prep_app = leg(disk_cache=DiskTileCache(disk_root))
    disk_stats = prep_app.disk_cache.stats()

    cfg = PrewarmConfig(events=(events,), top_k=len(hot),
                        budget_s=60.0, budget_bytes=256 << 20)
    warm_lat, warm_summary, _ = leg(disk_cache=DiskTileCache(disk_root),
                                    prewarm=cfg)

    cold, warmed = _lat_summary(cold_lat), _lat_summary(warm_lat)
    speedup = (round(cold["p99"] / warmed["p99"], 2)
               if cold["p99"] and warmed["p99"] else None)
    print(json.dumps({"cold_p99_ms": cold["p99"],
                      "warmed_p99_ms": warmed["p99"],
                      "speedup_p99": speedup}), flush=True)

    from heatmap_tpu_torch.tools import mem_probe

    paths = [f"/tiles/{layer}/{z}/{x}/{y}.{fmt}"
             for layer, z, x, y, fmt in universe]
    mapped = mem_probe.measure_fleet_pss(mapped_spec, args.rss_backends,
                                         paths)
    heap = mem_probe.measure_fleet_pss(heap_spec, args.rss_backends,
                                       paths)
    ratio = (round(mapped["total_mb"] / heap["total_mb"], 4)
             if mapped["total_mb"] and heap["total_mb"] else None)
    print(json.dumps({"fleet_rss_ratio": ratio,
                      "mapped_mb": mapped["total_mb"],
                      "heap_mb": heap["total_mb"]}), flush=True)

    return {
        "cold_warm": {
            "store": mapped_spec,
            "tiles": len(universe),
            "hot_tiles": len(hot),
            "cold": {"latency_ms": cold},
            "warmed": {"latency_ms": warmed,
                       "prewarm": warm_summary,
                       "disk_cache": disk_stats},
            "speedup_p99": speedup,
        },
        "fleet_rss": {
            "n": args.rss_backends,
            "mapped": mapped,
            "heap": heap,
            "pss_ratio": ratio,
            "source": mapped["source"],
        },
    }


def _recorder_overhead(host, port, universe, passes: int = 3) -> dict:
    """A/B the flight recorder against the live server: sequential
    full-universe sweeps (keep-alive, warmed cache) with the recorder
    off, then with shadow tracing (sample=0.0) + the ring installed —
    the always-on worst case where EVERY request runs real Span objects
    into the ring but none is head-sampled. Min-of-passes wall time on
    each side; the delta is the recorder's per-request tax. The ring's
    promise is that this stays in the low single digits — the bench
    gate alarms if it grows (obs:recorder_overhead_pct)."""
    from heatmap_tpu_torch.obs import recorder as recorder_mod
    from heatmap_tpu_torch.obs import tracing
    from heatmap_tpu_torch.obs.recorder import FlightRecorder

    def sweep() -> float:
        conn = http.client.HTTPConnection(host, port, timeout=30)
        t0 = time.perf_counter()
        for layer, z, x, y, fmt in universe:
            conn.request("GET", f"/tiles/{layer}/{z}/{x}/{y}.{fmt}")
            conn.getresponse().read()
        dt = time.perf_counter() - t0
        conn.close()
        return dt

    sweep()  # settle after the threaded window
    off_s = min(sweep() for _ in range(passes))
    tracing.enable_tracing(sample=0.0)
    recorder_mod.install(FlightRecorder())
    try:
        sweep()
        on_s = min(sweep() for _ in range(passes))
        stats = recorder_mod.get_recorder().stats()
    finally:
        recorder_mod.install(None)
        tracing.disable_tracing()
    pct = max(0.0, (on_s - off_s) / off_s * 100.0) if off_s else None
    result = {
        "recorder_overhead_pct": round(pct, 2) if pct is not None else None,
        "off_s": round(off_s, 4), "on_s": round(on_s, 4),
        "requests_per_pass": len(universe), "passes": passes,
        "ring_spans": stats["spans"], "ring_dropped": stats["dropped"],
    }
    print(json.dumps({"stage": "recorder_overhead", **result}), flush=True)
    return result


def _telemetry_overhead(host, port, universe, passes: int = 3) -> dict:
    """A/B the telemetry sampler against the live server: sequential
    full-universe sweeps with the sampler off, then armed at a 0.25 s
    interval (40x the production default cadence) with an anomaly
    engine attached — so registry snapshots, ring folds, and detector
    scoring all run while the sweep drives the hot path. The sampler is
    a background thread with zero hot-path hooks, so the promise is
    stronger than the recorder's: the delta should be measurement noise
    (the JAX bench gate folds it as obs:telemetry_overhead_pct with a
    5% noise floor). Also times ``/series`` queries against the
    freshly sampled history — the dashboard's polling cost."""
    from heatmap_tpu_torch.obs import anomaly as anomaly_mod
    from heatmap_tpu_torch.obs import timeseries
    from heatmap_tpu_torch.obs.anomaly import AnomalyEngine, parse_watch_spec

    def sweep() -> float:
        conn = http.client.HTTPConnection(host, port, timeout=30)
        t0 = time.perf_counter()
        for layer, z, x, y, fmt in universe:
            conn.request("GET", f"/tiles/{layer}/{z}/{x}/{y}.{fmt}")
            conn.getresponse().read()
        dt = time.perf_counter() - t0
        conn.close()
        return dt

    sweep()
    off_s = min(sweep() for _ in range(passes))
    engine = AnomalyEngine([parse_watch_spec("ingest_lag_seconds:z=8")])
    anomaly_mod.set_engine(engine)
    timeseries.arm(0.25, engine=engine)
    try:
        sweep()
        on_s = min(sweep() for _ in range(passes))
        stats = timeseries.get_store().stats()
        conn = http.client.HTTPConnection(host, port, timeout=30)
        q_lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            conn.request("GET", "/series?name=http_requests_total")
            conn.getresponse().read()
            q_lat.append((time.perf_counter() - t0) * 1000.0)
        conn.close()
    finally:
        timeseries.shutdown()
        anomaly_mod.set_engine(None)
    q_lat.sort()
    pct = max(0.0, (on_s - off_s) / off_s * 100.0) if off_s else None
    result = {
        "telemetry_overhead_pct": round(pct, 2) if pct is not None else None,
        "telemetry_off_s": round(off_s, 4),
        "telemetry_on_s": round(on_s, 4),
        "sample_interval_s": 0.25,
        "store_series": stats["series"],
        "store_samples": stats["samples_total"],
        "series_query_ms": {
            "p50": round(q_lat[len(q_lat) // 2], 3),
            "p99": round(q_lat[int(0.99 * (len(q_lat) - 1))], 3),
            "n": len(q_lat),
        },
    }
    print(json.dumps({"stage": "telemetry_overhead", **result}), flush=True)
    return result


def _fleet_bench(args, spec: str, universe, tmpdir: str) -> dict:
    """The N=1/2/4 scaling curve + kill-one-backend availability, all
    through real child serve processes and a threaded router frontend.

    Honest-measurement note: on a single-core host the backends (and
    the client subprocesses) serialize on the same CPU, so the curve
    records whatever this host can actually show — ``host_cores`` is
    in the record so the gate's trend comparisons stay like-for-like.
    """
    from heatmap_tpu_torch.serve import serve_in_thread
    from heatmap_tpu_torch.serve.fleet import FleetSupervisor

    sizes = [int(n) for n in args.fleet.split(",") if n.strip()]
    curve = []
    for n in sizes:
        with FleetSupervisor(spec, n, cache_bytes=args.cache_bytes,
                             probe_interval_s=0.25) as sup:
            sup.start()
            server, base = serve_in_thread(sup.router)
            _warm(base, universe)
            t0 = time.perf_counter()
            lat, statuses, errors = _drive_clients(
                base, universe, args.fleet_duration,
                workers=args.workers, procs=args.drive_procs,
                tmpdir=tmpdir)
            measured_s = time.perf_counter() - t0
            server.shutdown()
            server.server_close()
        row = {"n": n, "requests": int(len(lat)), "errors": errors,
               "statuses": statuses,
               "rps": round(len(lat) / measured_s, 1) if measured_s else None,
               "latency_ms": _lat_summary(lat)}
        curve.append(row)
        print(json.dumps({"fleet_n": n, "rps": row["rps"],
                          "p99_ms": row["latency_ms"]["p99"]}), flush=True)

    # Kill-one availability at the largest N: SIGKILL a backend a third
    # of the way through the window; router failover + supervisor
    # restart should keep 5xx at zero.
    n = max(sizes)
    with FleetSupervisor(spec, n, cache_bytes=args.cache_bytes,
                         probe_interval_s=0.25) as sup:
        sup.start()
        server, base = serve_in_thread(sup.router)
        _warm(base, universe)
        victim = sorted(sup.router.backends)[0]
        killer = threading.Timer(args.fleet_duration / 3,
                                 sup.kill_backend, args=(victim,))
        killer.start()
        lat, statuses, errors = _drive_clients(
            base, universe, args.fleet_duration,
            workers=args.workers, procs=args.drive_procs, tmpdir=tmpdir)
        killer.cancel()
        server.shutdown()
        server.server_close()
    total = int(len(lat)) + errors
    fives = sum(c for s, c in statuses.items() if s.startswith("5"))
    kill_one = {
        "n": n, "victim": victim, "requests": int(len(lat)),
        "errors": errors, "statuses": statuses, "status_5xx": int(fives),
        "availability": round((total - fives - errors) / total, 6)
        if total else None,
        "latency_ms": _lat_summary(lat),
    }
    print(json.dumps({"fleet_kill_one": kill_one["availability"],
                      "status_5xx": fives}), flush=True)
    return {
        "host_cores": os.cpu_count(),
        "workers_per_client": args.workers,
        "client_procs": args.drive_procs,
        "duration_s": args.fleet_duration,
        "curve": curve,
        "kill_one": kill_one,
        "note": "backends are real child processes; on hosts with few "
                "cores the curve is serialized on the CPU and "
                "understates multi-core scaling",
    }


def _adaptive_bench(args, spec: str) -> dict:
    """``--adaptive``: the brownout availability/fidelity curves for
    ``--adaptive-out``. One overload ramp (worker counts step up into
    saturation against a small admission bound, then back down) run
    twice over the same store: controller off, then controller on.

    The controller's burn source is a per-stage scripted schedule —
    the same fixed-burn discipline as the chaos soak's adaptive phase —
    so the ladder walks the ramp deterministically instead of
    depending on this host's latency noise; the *measured* side
    (latencies, statuses, synopsis stamps, shed causes) is real closed
    -loop traffic. Per stage the record carries availability (served /
    issued), the exact/synopsis/shed fractions, the worst stamped
    synopsis error, and the rung the ladder sat on."""
    from heatmap_tpu_torch.serve import (ServeApp, TileCache, TileStore,
                                   serve_in_thread)
    from heatmap_tpu_torch.serve import degrade

    # (workers, scripted burn): ramp into overload, hold, recover.
    stages = [(2, 0.2), (8, 1.5), (16, 2.5), (16, 3.5),
              (8, 0.2), (2, 0.2)]
    stage_s = args.adaptive_stage_s
    legs: dict = {}
    for leg in ("off", "on"):
        store = TileStore(spec)
        universe = tile_universe(store, args.tiles)
        burn_now = [0.0]
        ctl = None
        if leg == "on":
            # dwell = hold = half a stage: at most two ladder steps per
            # stage, so the ramp reads as a staircase in rung_trace
            # rather than slamming to max_rung in the first hot stage.
            ctl = degrade.BrownoutController(
                dwell_s=stage_s / 2, hold_s=stage_s / 2,
                poll_interval_s=0.05,
                burn_source=lambda: {"overload": burn_now[0]})
        app = ServeApp(store, TileCache(max_bytes=args.cache_bytes),
                       max_inflight=args.adaptive_inflight, degrade=ctl)
        server, base = serve_in_thread(app)
        host, port = server.server_address[:2]
        _warm(base, universe)
        rows = []
        for n_workers, burn in stages:
            burn_now[0] = burn
            stop_at = time.monotonic() + stage_s
            workers = [Worker(host, port, universe, stop_at, seed=i)
                       for i in range(n_workers)]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
            lat = np.sort(np.concatenate(
                [np.asarray(w.latencies_ms) for w in workers]
                or [np.zeros(0)]))
            statuses: dict = {}
            causes: dict = {}
            for w in workers:
                for s, c in w.statuses.items():
                    statuses[str(s)] = statuses.get(str(s), 0) + c
                for k, c in w.causes.items():
                    causes[k] = causes.get(k, 0) + c
            total = int(sum(statuses.values()))
            served = sum(c for s, c in statuses.items()
                         if s.startswith(("2", "304")))
            synopsis = int(sum(w.synopsis for w in workers))
            shed = statuses.get("503", 0)
            row = {
                "workers": n_workers, "burn": burn, "requests": total,
                "statuses": statuses,
                "errors": int(sum(w.errors for w in workers)),
                "availability": round(served / total, 4) if total else None,
                "frac_exact": round(max(0, served - synopsis) / total, 4)
                if total else None,
                "frac_synopsis": round(synopsis / total, 4)
                if total else None,
                "frac_shed": round(shed / total, 4) if total else None,
                "shed_causes": causes,
                "max_stamped_err": round(
                    max((w.max_err for w in workers), default=0.0), 6),
                "latency_ms": _lat_summary(lat),
                **({"rung": ctl.rung} if ctl is not None else {}),
            }
            rows.append(row)
            print(json.dumps({"adaptive": leg, **{k: row[k] for k in (
                "workers", "burn", "availability", "frac_synopsis",
                "frac_shed")}, **({"rung": ctl.rung}
                                  if ctl is not None else {})}),
                flush=True)
        server.shutdown()
        server.server_close()
        # Headline per leg: the overload stages (burn >= 1) are where
        # brownout control earns its keep; light stages always serve.
        hot = [r for (_, b), r in zip(stages, rows) if b >= 1.0]
        issued = sum(r["requests"] for r in hot)
        ok = sum(round(r["availability"] * r["requests"])
                 for r in hot if r["availability"] is not None)
        legs[leg] = {
            "stages": rows,
            "overload_availability": round(ok / issued, 4) if issued else None,
            "overload_p99_ms": max(
                (r["latency_ms"]["p99"] for r in hot
                 if r["latency_ms"]["p99"] is not None), default=None),
            "max_stamped_err": max(r["max_stamped_err"] for r in rows),
            **({"rung_trace": [r["rung"] for r in rows]}
               if leg == "on" else {}),
        }
    return {
        "bench": "adaptive",
        "store": spec,
        "stage_s": stage_s,
        "max_inflight": args.adaptive_inflight,
        "host_cores": os.cpu_count(),
        "stages": [{"workers": w, "burn": b} for w, b in stages],
        "legs": legs,
        "note": "burn is a scripted per-stage schedule (deterministic "
                "ladder), traffic and latencies are real closed-loop "
                "load; availability = served / issued over the "
                "overload stages",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="heatmap_tpu_torch.tools.load_gen")
    ap.add_argument("--store", default=None,
                    help="serve store spec (default: generate a "
                    "synthetic arrays artifact first)")
    ap.add_argument("--n-points", type=int, default=200_000,
                    help="synthetic points when generating the store")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--duration", type=float, default=10.0,
                    help="measured seconds (after warmup)")
    ap.add_argument("--tiles", type=int, default=512,
                    help="tile universe size (layer/z/x/y/fmt combos)")
    ap.add_argument("--cache-bytes", type=int, default=256 << 20)
    ap.add_argument("--ttl", type=float, default=None)
    ap.add_argument("--out", default=default_out("load_gen"),
                    help="record file (default %(default)s)")
    ap.add_argument("--fleet", default=None, metavar="N1,N2,...",
                    help="also bench the serve fleet at these backend "
                    "counts (e.g. 1,2,4) plus a kill-one-backend "
                    "availability run at the largest N")
    ap.add_argument("--fleet-duration", type=float, default=6.0,
                    help="measured seconds per fleet cell")
    ap.add_argument("--drive-procs", type=int, default=2,
                    help="client subprocesses per fleet cell (keeps the "
                    "load generator off a single GIL)")
    ap.add_argument("--adaptive", action="store_true",
                    help="run the brownout bench instead of the serve "
                    "bench: overload ramp with the degradation ladder "
                    "off vs on, availability + fidelity per stage")
    ap.add_argument("--adaptive-out", default=default_out("load_gen_adaptive"),
                    help="brownout record file (default %(default)s)")
    ap.add_argument("--adaptive-stage-s", type=float, default=3.0,
                    help="seconds per ramp stage")
    ap.add_argument("--adaptive-inflight", type=int, default=4,
                    help="server admission bound for the ramp (small on "
                    "purpose: the hot stages must actually overload)")
    ap.add_argument("--cold-vs-warm", action="store_true",
                    help="run the tilefs cold-vs-warmed restart A/B + "
                    "fleet Pss probe instead of the closed-loop bench; "
                    "merges cold_warm / fleet_rss blocks into --out "
                    "without clobbering a prior serve record")
    ap.add_argument("--rss-backends", type=int, default=3,
                    help="backends per fleet Pss leg (--cold-vs-warm)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the synthetic "
                    "store's job runs without --store (serving is host "
                    "work)")
    # --drive mode internals (subprocess client; not for direct use).
    ap.add_argument("--drive", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--universe-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seed-base", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.drive:  # a client process: no device, no torch
        return _drive(args)

    from heatmap_tpu_torch import obs
    from heatmap_tpu_torch.devices import resolve_device

    # The card (or --device cpu) runs only the job that builds a store.
    device = None if args.store else resolve_device(args.device)
    fields = HOST_FIELDS if device is None else device_fields(device)
    if args.cold_vs_warm:
        import shutil

        obs.enable_metrics(True)
        cw_tmp = tempfile.mkdtemp(prefix="loadgen-cw-")
        try:
            if args.store is None:
                t0 = time.perf_counter()
                args.store = synth_store(cw_tmp, args.n_points,
                                         sink="arrays-tilefs", device=device)
                print(json.dumps({
                    "stage": "synth_store", "spec": args.store,
                    "s": round(time.perf_counter() - t0, 2)}), flush=True)
            blocks = _cold_warm_bench(args, cw_tmp)
        finally:
            shutil.rmtree(cw_tmp, ignore_errors=True)
        # Merge, don't overwrite: the closed-loop record and this A/B
        # share one file.
        doc: dict = {}
        if os.path.exists(args.out):
            try:
                with open(args.out) as f:
                    loaded = json.load(f)
            except (OSError, ValueError):
                loaded = None
            if isinstance(loaded, dict):
                doc = loaded
        doc.setdefault("bench", "serve")
        doc.update(blocks)
        doc.update(fields)
        write_record(args.out, doc)
        return 0

    from heatmap_tpu_torch.serve import (ServeApp, TileCache, TileStore,
                                         serve_in_thread)
    from heatmap_tpu_torch.utils.trace import get_tracer

    obs.enable_metrics(True)
    tmpdir = None
    spec = args.store
    if spec is None:
        tmpdir = tempfile.mkdtemp(prefix="loadgen-")
        t0 = time.perf_counter()
        if args.adaptive:
            from heatmap_tpu_torch.pipeline import BatchJobConfig

            # A synopsis-carrying store: the coarse zooms synopsized,
            # the detail exact.
            spec = synth_store(
                tmpdir, args.n_points, sink="arrays-synopsis",
                config=BatchJobConfig(detail_zoom=10, min_detail_zoom=6,
                                      result_delta=2), device=device)
        else:
            spec = synth_store(tmpdir, args.n_points, device=device)
        print(json.dumps({"stage": "synth_store", "spec": spec,
                          "s": round(time.perf_counter() - t0, 2)}),
              flush=True)

    if args.adaptive:
        try:
            record = _adaptive_bench(args, spec)
        finally:
            if tmpdir:
                import shutil

                shutil.rmtree(tmpdir, ignore_errors=True)
        record.update(fields)
        write_record(args.adaptive_out, record)
        on, off = record["legs"]["on"], record["legs"]["off"]
        print(json.dumps({
            "availability_on": on["overload_availability"],
            "availability_off": off["overload_availability"],
            "p99_ms_on": on["overload_p99_ms"],
            "p99_ms_off": off["overload_p99_ms"],
            "rung_trace": on["rung_trace"],
        }), flush=True)
        return 0

    store = TileStore(spec)
    cache = TileCache(max_bytes=args.cache_bytes, ttl_s=args.ttl)
    app = ServeApp(store, cache)
    server, base = serve_in_thread(app)
    host, port = server.server_address[:2]
    universe = tile_universe(store, args.tiles)
    if not universe:
        server.shutdown()
        server.server_close()
        print(json.dumps({"error": "store has no blob-bearing tiles",
                          "store": spec}), flush=True)
        return 1

    # Warm-up: touch the whole universe once (cold renders fill the
    # cache), then snapshot the counters so the measured window's hit
    # rate leaves out the first-touch misses.
    conn = http.client.HTTPConnection(host, port, timeout=30)
    t0 = time.perf_counter()
    for layer, z, x, y, fmt in universe:
        conn.request("GET", f"/tiles/{layer}/{z}/{x}/{y}.{fmt}")
        conn.getresponse().read()
    conn.close()
    warm_s = time.perf_counter() - t0

    from heatmap_tpu_torch.serve.cache import CACHE_HITS, CACHE_MISSES

    hits0, misses0 = CACHE_HITS.value(), CACHE_MISSES.value()
    stop_at = time.monotonic() + args.duration
    workers = [Worker(host, port, universe, stop_at, seed=i)
               for i in range(args.workers)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    measured_s = time.perf_counter() - t0
    obs_overhead = _recorder_overhead(host, port, universe)
    obs_overhead.update(_telemetry_overhead(host, port, universe))
    server.shutdown()
    server.server_close()

    lat = np.sort(np.concatenate(
        [np.asarray(w.latencies_ms) for w in workers]
        or [np.zeros(0)]))
    statuses: dict = {}
    for w in workers:
        for s, c in w.statuses.items():
            statuses[str(s)] = statuses.get(str(s), 0) + c
    hits = CACHE_HITS.value() - hits0
    misses = CACHE_MISSES.value() - misses0
    total = hits + misses

    fleet = None
    if args.fleet:
        with tempfile.TemporaryDirectory(prefix="loadgen-fleet-") as scratch:
            fleet = _fleet_bench(args, spec, universe, scratch)

    record = {
        "bench": "serve",
        "store": spec,
        "workers": args.workers,
        "tiles": len(universe),
        "warmup_s": round(warm_s, 2),
        "duration_s": round(measured_s, 2),
        "requests": int(len(lat)),
        "errors": int(sum(w.errors for w in workers)),
        "statuses": statuses,
        "rps": round(len(lat) / measured_s, 1) if measured_s else None,
        "latency_ms": _lat_summary(lat),
        "hit_rate": round(hits / total, 4) if total else None,
        "cache": {"entries": len(cache), "bytes": cache.nbytes},
        "obs": obs_overhead,
        **({"fleet": fleet} if fleet else {}),
        "run_report": obs.build_run_report(tracer=get_tracer(),
                                           registry=obs.get_registry()),
        **fields,
    }
    write_record(args.out, record)
    headline = {k: record[k] for k in
                ("rps", "latency_ms", "hit_rate", "requests", "errors")}
    print(json.dumps(headline, default=str), flush=True)
    if tmpdir:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
