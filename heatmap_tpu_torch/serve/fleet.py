"""Serve-fleet supervisor: N shared-nothing backends + one router (the
port's copy of heatmap_tpu/serve/fleet.py).

Each backend is an ordinary :class:`ServeApp` over its **own**
``TileStore`` instance reading the same artifact — shared-nothing, so
a backend crash loses only its LRU, and rendezvous routing means each
backend's cache specializes to the key range the ring hands it.

Two backend modes behind one handle interface:

- ``process`` (production, ``serve --fleet N``): each backend is a
  child ``python -m heatmap_tpu_torch.serve.fleet --backend`` with its own
  interpreter (no shared GIL). The child binds an ephemeral port and
  reports it through a **port file** (atomic tmp+rename) — the
  supervisor never parses child output, and a child that dies before
  writing the file just times out the spawn.
- ``thread`` (tests, soak harnesses): the backend is an in-process
  ``ServeApp`` on a daemon HTTP thread. Same router, same wire
  protocol, no fork cost.

Crash handling: the monitor thread notices a dead backend, force-opens
its breaker (``fleet_backend_down``), and restarts it with exponential
backoff and seeded jitter (the ``faults/retry.py`` shape). The restart
does **not** re-admit the backend — the router's half-open health
probe does, once the replacement actually answers ``/healthz``
(``fleet_backend_up``). All waiting uses ``Event.wait``; nothing in
serve/ sleeps raw.

No backend touches the card: serving reads numpy levels only, and the
child's import path (``heatmap_tpu_torch``, then this module) never
calls ``torch.cuda``, so a fleet beside a busy card holds no CUDA
context and spends none of its memory.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.obs import anomaly, slo, timeseries
from heatmap_tpu_torch.serve import degrade as degrade_mod
from heatmap_tpu_torch.serve.cache import TileCache
from heatmap_tpu_torch.serve.http import ServeApp, make_server, serve_in_thread
from heatmap_tpu_torch.serve.router import (FLEET_RESTARTS, BackendClient,
                                      RouterApp)
from heatmap_tpu_torch.serve.store import TileStore
from heatmap_tpu_torch.tilefs import DiskTileCache, PrewarmConfig


def _backend_serving_extras(backend_id: str, disk_cache_opts,
                            prewarm_opts):
    """Materialize the per-backend disk cache + prewarm config from the
    supervisor's option dicts. Each backend caches under its own subdir
    — entries are cheap to refill and a shared directory would race the
    deterministic tmp names across processes."""
    disk_cache = None
    if disk_cache_opts and disk_cache_opts.get("root"):
        disk_cache = DiskTileCache(
            os.path.join(disk_cache_opts["root"], backend_id),
            max_bytes=int(disk_cache_opts.get("max_bytes", 1 << 30)))
    prewarm = None
    if prewarm_opts and prewarm_opts.get("events"):
        prewarm = PrewarmConfig(
            events=tuple(prewarm_opts["events"]),
            top_k=int(prewarm_opts.get("top_k", 64)),
            half_life=float(prewarm_opts.get("half_life", 512.0)),
            budget_s=float(prewarm_opts.get("budget_s", 10.0)),
            budget_bytes=int(prewarm_opts.get("budget_bytes", 64 << 20)))
    return disk_cache, prewarm


def _warm_in_background(app: ServeApp):
    """Replay the popularity plan without delaying readiness: the
    backend reports its port first, then fills caches while early
    requests are already being answered (worst case: they miss)."""
    if app.prewarm is None:
        return
    threading.Thread(target=app.prewarm_now,
                     kwargs={"source": "startup"},
                     name="prewarm", daemon=True).start()


class _ThreadBackend:
    """In-process backend: ServeApp + daemon HTTP thread."""

    def __init__(self, backend_id: str, store_factory, *,
                 host: str = "127.0.0.1", cache_bytes: int = 64 << 20,
                 max_inflight: int | None = None,
                 render_timeout_s: float | None = None,
                 degrade_opts: dict | None = None,
                 disk_cache_opts: dict | None = None,
                 prewarm_opts: dict | None = None):
        self.id = backend_id
        self._store_factory = store_factory
        self._host = host
        self._cache_bytes = cache_bytes
        self._max_inflight = max_inflight
        self._render_timeout_s = render_timeout_s
        self._degrade_opts = degrade_opts
        self._disk_cache_opts = disk_cache_opts
        self._prewarm_opts = prewarm_opts
        self.app: ServeApp | None = None
        self._server = None
        self._alive = False
        self.started_at = 0.0

    def start(self, stop_event: threading.Event | None = None):
        store = self._store_factory()
        # Each backend gets its own ladder; in thread mode they share
        # the process-global SLO engine, so they step together.
        controller = (degrade_mod.controller_from_flags(
            True, **self._degrade_opts) if self._degrade_opts else None)
        disk_cache, prewarm = _backend_serving_extras(
            self.id, self._disk_cache_opts, self._prewarm_opts)
        self.app = ServeApp(store, TileCache(max_bytes=self._cache_bytes),
                            max_inflight=self._max_inflight,
                            render_timeout_s=self._render_timeout_s,
                            degrade=controller, disk_cache=disk_cache,
                            prewarm=prewarm)
        self._server, _ = serve_in_thread(self.app, host=self._host)
        self._alive = True
        self.started_at = time.monotonic()
        host, port = self._server.server_address[:2]
        _warm_in_background(self.app)
        return host, port

    def alive(self) -> bool:
        return self._alive

    def kill(self):
        """Hard stop — the thread-mode stand-in for SIGKILL."""
        self._alive = False
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    stop = kill


class _ProcessBackend:
    """Child-process backend driven through ``--backend`` below."""

    def __init__(self, backend_id: str, store_spec: str, *,
                 host: str = "127.0.0.1", cache_bytes: int = 64 << 20,
                 max_inflight: int | None = None,
                 render_timeout_s: float | None = None,
                 chaos: str | None = None, workdir: str = ".",
                 spawn_timeout_s: float = 30.0,
                 degrade_opts: dict | None = None,
                 slo_specs: list | None = None,
                 disk_cache_opts: dict | None = None,
                 prewarm_opts: dict | None = None,
                 telemetry_opts: dict | None = None):
        self.id = backend_id
        self._store_spec = store_spec
        self._host = host
        self._cache_bytes = cache_bytes
        self._max_inflight = max_inflight
        self._render_timeout_s = render_timeout_s
        self._chaos = chaos
        self._workdir = workdir
        self._spawn_timeout_s = spawn_timeout_s
        self._degrade_opts = degrade_opts
        self._slo_specs = list(slo_specs or [])
        self._disk_cache_opts = disk_cache_opts
        self._prewarm_opts = prewarm_opts
        self._telemetry_opts = telemetry_opts
        self.proc: subprocess.Popen | None = None
        self.started_at = 0.0
        self._seq = 0

    def start(self, stop_event: threading.Event | None = None):
        self._seq += 1
        port_file = os.path.join(self._workdir,
                                 f"{self.id}.{self._seq}.port")
        argv = [sys.executable, "-m", "heatmap_tpu_torch.serve.fleet",
                "--backend", "--store", self._store_spec,
                "--port-file", port_file, "--host", self._host,
                "--cache-bytes", str(self._cache_bytes)]
        if self._max_inflight is not None:
            argv += ["--max-inflight", str(self._max_inflight)]
        if self._render_timeout_s is not None:
            argv += ["--render-timeout", str(self._render_timeout_s)]
        if self._chaos:
            argv += ["--chaos", self._chaos]
        for spec in self._slo_specs:
            argv += ["--slo", spec]
        if self._telemetry_opts and self._telemetry_opts.get("interval"):
            # Forwarded like --slo: each child samples its own registry
            # so the router's fleet-merged /series carries per-backend
            # history, and child-side watches score child-side traffic.
            argv += ["--telemetry-sample-interval",
                     str(self._telemetry_opts["interval"])]
            for spec in self._telemetry_opts.get("watches") or []:
                argv += ["--watch", spec]
        if self._degrade_opts:
            argv += ["--degrade",
                     "--degrade-dwell",
                     str(self._degrade_opts.get("dwell_s", 10.0)),
                     "--degrade-hold",
                     str(self._degrade_opts.get("hold_s", 30.0))]
            ladder = self._degrade_opts.get("ladder_spec", "")
            if ladder:
                argv += ["--degrade-ladder", ladder]
        if self._disk_cache_opts and self._disk_cache_opts.get("root"):
            # Per-backend subdir (same reasoning as
            # _backend_serving_extras): a shared directory would race
            # the deterministic tmp names across processes.
            argv += ["--disk-cache",
                     os.path.join(self._disk_cache_opts["root"], self.id),
                     "--disk-cache-bytes",
                     str(self._disk_cache_opts.get("max_bytes", 1 << 30))]
        if self._prewarm_opts and self._prewarm_opts.get("events"):
            for path in self._prewarm_opts["events"]:
                argv += ["--prewarm-events", path]
            argv += ["--prewarm-top-k",
                     str(self._prewarm_opts.get("top_k", 64)),
                     "--prewarm-budget-s",
                     str(self._prewarm_opts.get("budget_s", 10.0)),
                     "--prewarm-bytes",
                     str(self._prewarm_opts.get("budget_bytes", 64 << 20))]
        env = os.environ.copy()
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get(
            "PYTHONPATH", "")
        self.proc = subprocess.Popen(argv, env=env,
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.DEVNULL)
        self.started_at = time.monotonic()
        return self._wait_port(port_file, stop_event)

    def _wait_port(self, port_file: str, stop_event):
        waiter = stop_event or threading.Event()
        deadline = time.monotonic() + self._spawn_timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"backend {self.id} exited with "
                    f"{self.proc.returncode} before binding a port")
            try:
                with open(port_file) as fh:
                    info = json.load(fh)
                os.unlink(port_file)
                return info["host"], int(info["port"])
            except (OSError, ValueError, KeyError):
                if waiter.wait(0.02):
                    raise RuntimeError("supervisor stopping") from None
        raise RuntimeError(
            f"backend {self.id} did not report a port within "
            f"{self._spawn_timeout_s}s")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self):
        """SIGKILL — the chaos path (``backend_loss``)."""
        if self.proc is not None:
            self.proc.kill()

    def stop(self):
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5.0)


class FleetSupervisor:
    """Spawn N backends, front them with a :class:`RouterApp`, restart
    crashers with exponential backoff, let half-open probes re-admit.

    ``mode="process"`` needs ``store_spec`` (a ``TileStore`` spec
    string); ``mode="thread"`` accepts ``store_factory`` instead for
    stores that are not spec-addressable (tests over tmp dirs are).
    """

    def __init__(self, store_spec: str | None, n_backends: int, *,
                 mode: str = "process", store_factory=None,
                 host: str = "127.0.0.1", cache_bytes: int = 64 << 20,
                 backend_max_inflight: int | None = None,
                 render_timeout_s: float | None = None,
                 chaos: str | None = None,
                 max_inflight: int = 32, queue_deadline_s: float = 0.25,
                 hedge_quantile: float = 0.95,
                 probe_interval_s: float = 0.25,
                 restart_base_s: float = 0.2, restart_cap_s: float = 5.0,
                 monitor_interval_s: float = 0.1,
                 spawn_timeout_s: float = 30.0,
                 degrade_opts: dict | None = None,
                 slo_specs: list | None = None,
                 disk_cache_opts: dict | None = None,
                 prewarm_opts: dict | None = None,
                 telemetry_opts: dict | None = None):
        if mode not in ("process", "thread"):
            raise ValueError(f"unknown fleet mode {mode!r}")
        if mode == "process" and not store_spec:
            raise ValueError("process mode needs a store spec")
        self.mode = mode
        self.n_backends = int(n_backends)
        if self.n_backends < 1:
            raise ValueError("a fleet needs at least one backend")
        self._store_spec = store_spec
        self._store_factory = store_factory or (
            lambda: TileStore(store_spec))
        self._host = host
        self._cache_bytes = cache_bytes
        self._backend_max_inflight = backend_max_inflight
        self._render_timeout_s = render_timeout_s
        self._chaos = chaos
        self._spawn_timeout_s = spawn_timeout_s
        self._degrade_opts = degrade_opts
        self._slo_specs = list(slo_specs or [])
        self._disk_cache_opts = disk_cache_opts
        self._prewarm_opts = prewarm_opts
        # process mode only: thread-mode backends share the supervisor
        # process's global sampler/engine (same sharing as the SLO
        # engine above), so there is nothing per-backend to arm.
        self._telemetry_opts = telemetry_opts
        self.restart_base_s = restart_base_s
        self.restart_cap_s = restart_cap_s
        self.monitor_interval_s = monitor_interval_s
        self._router_opts = dict(max_inflight=max_inflight,
                                 queue_deadline_s=queue_deadline_s,
                                 hedge_quantile=hedge_quantile,
                                 probe_interval_s=probe_interval_s)
        self.router: RouterApp | None = None
        self._handles: dict = {}
        self._restart_counts: dict[str, int] = {}
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self._workdir: str | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self.mode == "process":
            self._workdir = tempfile.mkdtemp(prefix="heatmap-fleet-")
        clients = []
        try:
            for i in range(self.n_backends):
                backend_id = f"b{i}"
                handle = self._make_handle(backend_id)
                host, port = handle.start(self._stop)
                self._handles[backend_id] = handle
                clients.append(BackendClient(backend_id, host, port))
        except Exception:
            self.stop()
            raise
        self.router = RouterApp(clients, **self._router_opts).start()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="fleet-monitor", daemon=True)
        self._monitor.start()
        return self

    def _make_handle(self, backend_id: str):
        if self.mode == "thread":
            return _ThreadBackend(
                backend_id, self._store_factory, host=self._host,
                cache_bytes=self._cache_bytes,
                max_inflight=self._backend_max_inflight,
                render_timeout_s=self._render_timeout_s,
                degrade_opts=self._degrade_opts,
                disk_cache_opts=self._disk_cache_opts,
                prewarm_opts=self._prewarm_opts)
        return _ProcessBackend(
            backend_id, self._store_spec, host=self._host,
            cache_bytes=self._cache_bytes,
            max_inflight=self._backend_max_inflight,
            render_timeout_s=self._render_timeout_s, chaos=self._chaos,
            workdir=self._workdir, spawn_timeout_s=self._spawn_timeout_s,
            degrade_opts=self._degrade_opts, slo_specs=self._slo_specs,
            disk_cache_opts=self._disk_cache_opts,
            prewarm_opts=self._prewarm_opts,
            telemetry_opts=self._telemetry_opts)

    def stop(self):
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        if self.router is not None:
            self.router.close()
        for handle in self._handles.values():
            try:
                handle.stop()
            except Exception:
                pass
        self._handles.clear()
        if self._workdir is not None:
            shutil.rmtree(self._workdir, ignore_errors=True)
            self._workdir = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- chaos / test hooks ------------------------------------------------

    def kill_backend(self, backend_id: str):
        """SIGKILL (or thread-mode equivalent) — the monitor restarts
        it; the router's probes re-admit it."""
        self._handles[backend_id].kill()

    def backend(self, backend_id: str):
        return self._handles[backend_id]

    # -- monitor -----------------------------------------------------------

    def _restart_delay_s(self, backend_id: str, count: int) -> float:
        plane = faults.get_plane()
        seed = plane.seed if plane is not None else 0
        scale = plane.backoff_scale if plane is not None else 1.0
        nominal = min(self.restart_cap_s,
                      self.restart_base_s * 2.0 ** count)
        jitter = 0.5 + 0.5 * faults.hash01(
            seed, "restart", backend_id, count)
        return nominal * jitter * scale

    def _monitor_loop(self):
        pending: dict[str, float] = {}  # backend_id -> restart deadline
        while not self._stop.wait(self.monitor_interval_s):
            now = time.monotonic()
            for backend_id, handle in list(self._handles.items()):
                client = self.router.backends[backend_id]
                if handle.alive():
                    # Stable for a while: forget the crash history so
                    # the next incident starts from the base delay.
                    if (backend_id in self._restart_counts
                            and now - handle.started_at
                            > 4 * self.restart_cap_s):
                        self._restart_counts.pop(backend_id, None)
                    continue
                if backend_id not in pending:
                    self.router.note_failure(client, "crashed", force=True)
                    count = self._restart_counts.get(backend_id, 0)
                    pending[backend_id] = (
                        now + self._restart_delay_s(backend_id, count))
                    continue
                if now < pending[backend_id]:
                    continue
                del pending[backend_id]
                self._restart_counts[backend_id] = (
                    self._restart_counts.get(backend_id, 0) + 1)
                try:
                    replacement = self._make_handle(backend_id)
                    host, port = replacement.start(self._stop)
                except Exception:
                    # Spawn failed (port timeout, bad artifact): leave
                    # the breaker open and try again after a full cap.
                    pending[backend_id] = (time.monotonic()
                                           + self.restart_cap_s)
                    continue
                self._handles[backend_id] = replacement
                client.set_address(host, port)
                if obs.metrics_enabled():
                    FLEET_RESTARTS.inc(backend=backend_id)


# -- backend child process entrypoint --------------------------------------


def backend_main(argv=None) -> int:
    """``python -m heatmap_tpu_torch.serve.fleet --backend``: one ServeApp on
    an ephemeral port, reported through ``--port-file`` (atomic write).
    No output on stdout/stderr — the port file is the only protocol."""
    parser = argparse.ArgumentParser(prog="heatmap_tpu_torch.serve.fleet")
    parser.add_argument("--backend", action="store_true", required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--port-file", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--cache-bytes", type=int, default=64 << 20)
    parser.add_argument("--max-inflight", type=int, default=None)
    parser.add_argument("--render-timeout", type=float, default=None)
    parser.add_argument("--chaos", default=None)
    parser.add_argument("--slo", action="append", default=[])
    parser.add_argument("--telemetry-sample-interval", type=float,
                        default=0.0)
    parser.add_argument("--watch", action="append", default=[])
    parser.add_argument("--degrade", action="store_true")
    parser.add_argument("--degrade-dwell", type=float, default=10.0)
    parser.add_argument("--degrade-hold", type=float, default=30.0)
    parser.add_argument("--degrade-ladder", default="")
    parser.add_argument("--disk-cache", default=None)
    parser.add_argument("--disk-cache-bytes", type=int, default=1 << 30)
    parser.add_argument("--prewarm-events", action="append", default=[])
    parser.add_argument("--prewarm-top-k", type=int, default=64)
    parser.add_argument("--prewarm-budget-s", type=float, default=10.0)
    parser.add_argument("--prewarm-bytes", type=int, default=64 << 20)
    args = parser.parse_args(argv)

    faults.install_from_env(args.chaos)
    obs.enable_metrics(True)
    # Per-child SLO engine: the brownout ladder's burn source. The
    # supervisor forwards the serve process's --slo specs so every
    # backend evaluates the same objectives over its own traffic.
    if args.slo:
        slo.install_specs(args.slo)
    # Per-child telemetry sampler + watches (forwarded like --slo):
    # each backend samples its own registry so the router's
    # fleet-merged /series carries per-backend history. 0 = the
    # pinned zero-cost off path — nothing armed.
    if args.telemetry_sample_interval:
        engine = None
        if args.watch:
            engine = anomaly.AnomalyEngine(
                [anomaly.parse_watch_spec(s) for s in args.watch])
            anomaly.set_engine(engine)
        timeseries.arm(args.telemetry_sample_interval, engine=engine)
    controller = degrade_mod.controller_from_flags(
        args.degrade, args.degrade_dwell, args.degrade_hold,
        args.degrade_ladder)
    store = TileStore(args.store)
    disk_cache = (DiskTileCache(args.disk_cache,
                                max_bytes=args.disk_cache_bytes)
                  if args.disk_cache else None)
    prewarm = (PrewarmConfig(events=tuple(args.prewarm_events),
                             top_k=args.prewarm_top_k,
                             budget_s=args.prewarm_budget_s,
                             budget_bytes=args.prewarm_bytes)
               if args.prewarm_events else None)
    app = ServeApp(store, TileCache(max_bytes=args.cache_bytes),
                   max_inflight=args.max_inflight,
                   render_timeout_s=args.render_timeout,
                   degrade=controller, disk_cache=disk_cache,
                   prewarm=prewarm)
    server = make_server(app, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"host": host, "port": port, "pid": os.getpid()}, fh)
    os.replace(tmp, args.port_file)
    _warm_in_background(app)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        timeseries.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(backend_main())
