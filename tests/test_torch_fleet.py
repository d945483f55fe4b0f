"""The port's serve fleet (heatmap_tpu_torch.serve.router and .fleet)
against the JAX package's on the CPU, over loopback sockets only.

Mirrors tests/test_fleet.py: rendezvous placement and ring moves equal
the JAX functions'; the breaker's state machine (and its seeded
cooldowns) is the JAX one's; typed 503s, drain and undrain, rolling
reload and hedging behave the same; a thread-mode fleet of 3 answers
every path with the single-process port app's bytes and ETag and with
the JAX fleet's; a killed backend returns to the ring; the merged
``/metrics`` exposition is one parse-valid document and equals the JAX
merge; the process backend's argv names ``heatmap_tpu_torch.serve.fleet``
and carries the telemetry flags; and one real process-mode fleet of 2
serves a small store, restarts a SIGKILLed child, and its children
never touch ``torch.cuda``.
"""

from __future__ import annotations

import http.server
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from heatmap_tpu import faults as jfaults
from heatmap_tpu.serve import router as jrouter
from heatmap_tpu.serve import BackendClient as JClient
from heatmap_tpu.serve import RouterApp as JRouter
from heatmap_tpu.serve import ServeApp as JApp
from heatmap_tpu.serve import TileCache as JCache
from heatmap_tpu.serve import TileStore as JStore
from heatmap_tpu.serve import serve_in_thread as jserve_in_thread
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.serve import (BackendClient, CircuitBreaker,
                                     FleetSupervisor, RouterApp, ServeApp,
                                     TileCache, TileStore, rendezvous_order,
                                     route_key, serve_in_thread)
from heatmap_tpu_torch.serve import router as trouter
from heatmap_tpu_torch.tilemath.morton import morton_decode_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    yield
    obs.set_event_log(None)
    obs.enable_metrics(False)
    obs.get_registry().reset()
    faults.install(None)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One small batch job egressed by the port as a columnar arrays
    store: the ground truth every fleet in this file serves."""
    root = tmp_path_factory.mktemp("fleet_artifacts")
    assert tcli.main(["run", "--input", "synthetic:2000:11", "--backend",
                      "cpu", "--detail-zoom", "9", "--min-detail-zoom", "5",
                      "--output", f"arrays:{root}/levels"]) == 0
    return f"arrays:{root}/levels"


def _get(url, **headers):
    req = urllib.request.Request(url, headers=headers)
    try:
        resp = urllib.request.urlopen(req)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(url):
    req = urllib.request.Request(url, method="POST")
    try:
        resp = urllib.request.urlopen(req)
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _tile_paths(store, limit=24, fmt="json"):
    """A deterministic sample of tile request paths across zooms."""
    paths = []
    layer = store.layer("default")
    delta = layer.result_delta
    for d in layer.detail_zooms:
        codes = np.unique(
            np.asarray(layer.levels[d].codes[:64], np.int64) >> (2 * delta))
        rows, cols = morton_decode_np(codes[:4])
        for r, c in zip(rows, cols):
            paths.append(
                f"/tiles/default/{d - delta}/{int(c)}/{int(r)}.{fmt}")
            if len(paths) >= limit:
                return paths
    return paths


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


class _FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# -- rendezvous -------------------------------------------------------------


class TestRendezvous:
    def test_placement_equals_jax(self):
        for n in (1, 2, 3, 5, 8):
            ring = [f"b{i}" for i in range(n)]
            for key in ["default/3/1/2", "default/9/100/7", "/healthz",
                        "query:default/5/0,0,1,1"] + [
                            f"l/{z}/{x}/{x * 7 % 13}" for z in range(3)
                            for x in range(20)]:
                order = rendezvous_order(key, ring)
                assert order == jrouter.rendezvous_order(key, ring)
                assert sorted(order) == sorted(ring)
                assert rendezvous_order(key, list(reversed(ring))) == order

    def test_membership_change_moves_only_the_lost_backends_keys(self):
        n = 4
        ring = [f"b{i}" for i in range(n)]
        keys = [f"layer/{z}/{x}/{y}"
                for z in range(4) for x in range(8) for y in range(8)]
        owner_before = {k: rendezvous_order(k, ring)[0] for k in keys}
        shrunk = [b for b in ring if b != "b2"]
        moved = 0
        for k in keys:
            after = rendezvous_order(k, shrunk)[0]
            assert after == jrouter.rendezvous_order(k, shrunk)[0]
            if owner_before[k] == "b2":
                moved += 1
            else:
                assert after == owner_before[k]
        assert moved / len(keys) <= 1.0 / n + 0.10

    @pytest.mark.parametrize("path", [
        "/tiles/default/3/1/2.json", "/tiles/default/3/1/2.png",
        "/tiles/a%7Cb/3/1/2.json?synopsis=1", "/healthz",
        "/query?op=sum&layer=x&z=4&bbox=0,0,3,3",
        "/query?op=topk&k=3&z=4&bbox=0,0,3,3", "/metrics?fleet=1"])
    def test_route_key_equals_jax(self, path):
        assert route_key(path) == jrouter.route_key(path)
        assert (route_key("/tiles/default/3/1/2.json")
                == route_key("/tiles/default/3/1/2.png") == "default/3/1/2")


# -- circuit breaker --------------------------------------------------------


class TestCircuitBreaker:
    def test_threshold_edge_and_single_half_open_trial(self):
        clock = _FakeClock()
        br = CircuitBreaker("b0", fail_threshold=3, open_base_s=1.0,
                            clock=clock)
        assert br.admits() and br.state == CircuitBreaker.CLOSED
        assert br.record_failure() is False
        assert br.record_failure() is False
        assert br.admits()
        assert br.record_failure() is True
        assert not br.admits()
        assert br.state == CircuitBreaker.OPEN
        assert not br.admits_trial()
        clock.t += 2.0
        assert br.state == CircuitBreaker.HALF_OPEN
        assert br.admits_trial()
        assert not br.admits_trial()
        assert not br.admits()
        assert br.record_success() is True
        assert br.admits()
        assert br.record_success() is False

    @pytest.mark.parametrize("seed", [None, 7])
    def test_cooldowns_equal_jax(self, seed):
        """The same failure sequence on both breakers, with the same
        fault plane's seed, gives the same edges and cooldowns."""
        if seed is not None:
            faults.install_spec(f"seed={seed}")
            jfaults.install_spec(f"seed={seed}")
        try:
            got = []
            for cls in (CircuitBreaker, jrouter.CircuitBreaker):
                clock = _FakeClock()
                br = cls("b0", fail_threshold=1, open_base_s=1.0,
                         open_cap_s=60.0, clock=clock)
                seq = [br.record_failure(), br._open_until - clock.t]
                for _ in range(4):
                    clock.t = br._open_until
                    seq += [br.admits_trial(), br.record_failure(),
                            br._open_until - clock.t]
                got.append(seq)
        finally:
            jfaults.install(None)
        assert got[0] == got[1]
        jitter = 0.5 + 0.5 * faults.hash01(seed or 0, "breaker", "b0", 1)
        assert got[0][1] == pytest.approx(1.0 * jitter)

    def test_force_opens_immediately(self):
        br = CircuitBreaker("b0", fail_threshold=5, clock=_FakeClock())
        assert br.record_failure(force=True) is True
        assert not br.admits()

    def test_success_resets_the_failure_streak(self):
        br = CircuitBreaker("b0", fail_threshold=3, clock=_FakeClock())
        for _ in range(4):
            assert br.record_failure() is False
            br.record_success()
        assert br.admits()


class TestFleetEvents:
    def test_one_down_up_pair_per_outage(self, tmp_path):
        clock = _FakeClock()
        backend = BackendClient("b7", "127.0.0.1", 1,
                                breaker=CircuitBreaker(
                                    "b7", fail_threshold=2, clock=clock))
        router = RouterApp([backend], clock=clock)
        log = obs.EventLog(str(tmp_path / "events.jsonl"))
        obs.set_event_log(log)
        try:
            router.note_failure(backend, "connect", "refused")
            router.note_failure(backend, "connect", "refused")
            router.note_failure(backend, "connect", "refused")
            clock.t += 60.0
            assert backend.breaker.admits_trial()
            router.note_failure(backend, "probe")
            clock.t += 120.0
            assert backend.breaker.admits_trial()
            router.note_success(backend)
            router.note_success(backend)
        finally:
            obs.set_event_log(None)
            log.close()
        events = [(e["event"], e["backend"]) for e in
                  obs.read_events(str(tmp_path / "events.jsonl"))
                  if e["event"].startswith("fleet_backend")]
        assert events == [("fleet_backend_down", "b7"),
                          ("fleet_backend_up", "b7")]


class TestServeAppAdmission:
    @pytest.fixture()
    def served(self, artifacts):
        app = ServeApp(TileStore(artifacts), TileCache(max_bytes=1 << 20),
                       max_inflight=4, retry_after_s=2.0)
        server, base = serve_in_thread(app)
        yield app, base
        server.shutdown()
        server.server_close()

    def test_shed_is_typed_503_with_retry_after(self, served):
        app, base = served
        path = _tile_paths(app.store, limit=1)[0]
        app.max_inflight = 0
        status, headers, body = _get(base + path)
        assert status == 503
        assert json.loads(body)["cause"] == "shed"
        assert 1 <= int(headers["Retry-After"]) <= 3
        health = json.loads(_get(f"{base}/healthz")[2])
        assert health["status"] == "degraded" and "shed" in health["degraded"]
        app.max_inflight = 4
        assert _get(base + path)[0] == 200
        assert json.loads(_get(f"{base}/healthz")[2])["status"] == "ok"

    def test_drain_undrain_roundtrip(self, served):
        app, base = served
        path = _tile_paths(app.store, limit=1)[0]
        status, body = _post(f"{base}/drain")
        assert (status, json.loads(body)["draining"]) == (200, True)
        status, headers, body = _get(base + path)
        assert (status, json.loads(body)["cause"]) == (503, "drain")
        assert "Retry-After" in headers
        status, body = _post(f"{base}/undrain")
        assert (status, json.loads(body)["draining"]) == (200, False)
        assert _get(base + path)[0] == 200


# -- thread fleets of 3 -----------------------------------------------------


def _fleet(apps, Client, Router, serve):
    backends, servers = [], []
    for i, app in enumerate(apps):
        server, base = serve(app)
        host, port = base.rsplit("://", 1)[1].rsplit(":", 1)
        backends.append(Client(f"b{i}", host, int(port)))
        servers.append(server)
    router = Router(backends, probe_interval_s=0.05).start()
    server, base = serve(router)
    return router, server, base, backends, servers


def _close(router, server, servers):
    router.close()
    server.shutdown()
    server.server_close()
    for s in servers:
        s.shutdown()
        s.server_close()


@pytest.fixture()
def fleet3(artifacts):
    """Three port ServeApps behind the port's router, the single-process
    port app, and the JAX package's fleet of 3 over the same store."""
    store = TileStore(artifacts)
    reference = ServeApp(store, TileCache(max_bytes=1 << 20))
    router, server, base, backends, servers = _fleet(
        [ServeApp(TileStore(artifacts), TileCache(max_bytes=1 << 20))
         for _ in range(3)], BackendClient, RouterApp, serve_in_thread)
    jrouter_, jserver, jbase, _, jservers = _fleet(
        [JApp(JStore(artifacts), JCache(max_bytes=1 << 20))
         for _ in range(3)], JClient, JRouter, jserve_in_thread)
    yield {"router": router, "base": base, "reference": reference,
           "store": store, "backends": backends, "servers": servers,
           "jbase": jbase}
    _close(router, server, servers)
    _close(jrouter_, jserver, jservers)


class TestRouterByteEquality:
    @pytest.mark.parametrize("fmt", ["json", "png"])
    def test_every_path_matches_the_app_and_the_jax_fleet(self, fleet3, fmt):
        base, ref = fleet3["base"], fleet3["reference"]
        paths = _tile_paths(fleet3["store"], fmt=fmt) + [
            "/tiles/default/0/5/0.png", "/tiles/nope/3/1/1.json",
            "/query?op=sum&z=4&bbox=0,0,15,15", "/nothing"]
        for path in paths:
            want_status, want_ctype, want_body, want_etag, _, _ = (
                ref.handle("GET", path))
            status, headers, body = _get(base + path)
            assert (status, body) == (want_status, want_body), path
            assert headers["Content-Type"] == want_ctype
            assert headers.get("ETag") == want_etag
            jstatus, jheaders, jbody = _get(fleet3["jbase"] + path)
            assert (jstatus, jbody, jheaders.get("ETag")) == (
                status, body, headers.get("ETag")), path
            if want_etag:
                status, headers, body = _get(
                    base + path, **{"If-None-Match": want_etag})
                assert (status, body) == (304, b"")

    def test_router_healthz_names_the_ring(self, fleet3):
        health = json.loads(_get(fleet3["base"] + "/healthz")[2])
        jhealth = json.loads(_get(fleet3["jbase"] + "/healthz")[2])
        assert health["role"] == jhealth["role"] == "router"
        assert sorted(health["fleet"]["eligible"]) == ["b0", "b1", "b2"]
        assert health["fleet"]["backends"]["b1"]["breaker"] == "closed"
        assert set(health) == set(jhealth)
        assert health["admission"] == jhealth["admission"]


class TestFailoverAndReadmission:
    def test_connection_failure_retries_next_replica(self, fleet3, tmp_path,
                                                     artifacts):
        base, ref, store = (fleet3["base"], fleet3["reference"],
                            fleet3["store"])
        log = obs.EventLog(str(tmp_path / "events.jsonl"))
        obs.set_event_log(log)
        try:
            victim = fleet3["backends"][0]
            fleet3["servers"][0].shutdown()
            fleet3["servers"][0].server_close()
            # A stopped ThreadingHTTPServer keeps answering on the
            # keep-alive connections it already holds (a crashed process
            # would close them): drop the router's pooled ones, so every
            # later attempt meets the closed port.
            host, port = victim.address.rsplit(":", 1)
            victim.set_address(host, int(port))
            for path in _tile_paths(store):
                want = ref.handle("GET", path)
                status, _, body = _get(base + path)
                assert (status, body) == (want[0], want[2]), path

            def eligible():
                return json.loads(_get(base + "/healthz")[2])[
                    "fleet"]["eligible"]

            assert _wait(lambda: victim.id not in eligible())
            app = ServeApp(TileStore(artifacts), TileCache(max_bytes=1 << 20))
            server, vbase = serve_in_thread(app)
            fleet3["servers"][0] = server
            host, port = vbase.rsplit("://", 1)[1].rsplit(":", 1)
            victim.set_address(host, int(port))
            assert _wait(lambda: victim.id in eligible())
        finally:
            obs.set_event_log(None)
            log.close()
        events = [(e["event"], e["backend"]) for e in
                  obs.read_events(str(tmp_path / "events.jsonl"))
                  if e["event"].startswith("fleet_backend")]
        assert (events.count(("fleet_backend_down", victim.id)),
                events.count(("fleet_backend_up", victim.id))) == (1, 1)


class TestRollingReload:
    def test_reload_is_atomic_per_backend(self, fleet3):
        status, body = _post(f"{fleet3['base']}/reload")
        doc = json.loads(body)
        assert status == 200 and doc["ok"] is True
        assert all(doc["backends"][b]["ok"] for b in ("b0", "b1", "b2"))

    def test_failed_backend_keeps_last_good_and_is_ejected(self, fleet3):
        base, store, ref = (fleet3["base"], fleet3["store"],
                            fleet3["reference"])
        victim = fleet3["backends"][1]
        good_host, good_port = victim.address.rsplit(":", 1)
        victim.set_address("127.0.0.1", 1)
        status, body = _post(f"{base}/reload")
        doc = json.loads(body)
        assert status == 503 and doc["ok"] is False
        assert doc["backends"][victim.id]["ok"] is False
        health = json.loads(_get(base + "/healthz")[2])
        assert victim.id not in health["fleet"]["eligible"]
        assert (health["fleet"]["backends"][victim.id]["ejected"]
                == "reload_failed")
        for path in _tile_paths(store, limit=6):
            want = ref.handle("GET", path)
            status, _, body = _get(base + path)
            assert (status, body) == (want[0], want[2])
        victim.set_address(good_host, int(good_port))
        status, body = _post(f"{base}/reload")
        assert (status, json.loads(body)["ok"]) == (200, True)
        assert victim.ejected is None
        if victim.breaker.state != "closed":
            # The prober (every 50 ms) reached the bad address three
            # times before the restore, which opens the breaker: the
            # backend rejoins on the first half-open probe after the
            # cooldown, as in the JAX router.
            deadline = time.monotonic() + 30.0
            while (victim.breaker.state != "closed"
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        health = json.loads(_get(base + "/healthz")[2])
        assert victim.id in health["fleet"]["eligible"]

    @pytest.mark.parametrize("op", ["drain", "undrain"])
    def test_fleet_drain_ops(self, fleet3, op):
        base = fleet3["base"]
        status, body = _post(f"{base}/fleet/b2/{op}")
        doc = json.loads(body)
        assert status == 200 and doc["draining"] is (op == "drain")
        assert doc["backend_response"]["status"] == 200
        eligible = json.loads(_get(base + "/healthz")[2])["fleet"]["eligible"]
        assert ("b2" in eligible) is (op == "undrain")
        assert _post(f"{base}/fleet/b9/drain")[0] == 404
        assert _post(f"{base}/fleet/b2/explode")[0] == 404


class TestRouterAdmission:
    def test_empty_ring_is_typed_503_never_500(self):
        backend = BackendClient("b0", "127.0.0.1", 1)
        backend.breaker.record_failure(force=True)
        router = RouterApp([backend])
        server, base = serve_in_thread(router)
        try:
            status, headers, body = _get(base + "/tiles/default/5/0/0.json")
            assert status == 503
            assert json.loads(body)["cause"] == "no_backends"
            assert "Retry-After" in headers
        finally:
            server.shutdown()
            server.server_close()

    def test_queue_deadline_overload_is_typed_503(self, fleet3):
        router = fleet3["router"]
        router.max_inflight = 0
        router.queue_deadline_s = 0.05
        status, headers, body = _get(
            fleet3["base"] + _tile_paths(fleet3["store"], limit=1)[0])
        assert status == 503
        assert json.loads(body)["cause"] == "overload"
        assert "Retry-After" in headers

    def test_unreachable_ring_is_typed_503(self):
        """Every replica refuses the connection: one retry, then a typed
        upstream_unreachable 503."""
        backends = [BackendClient(f"b{i}", "127.0.0.1", 1) for i in range(2)]
        router = RouterApp(backends)
        status, _, body, *_ = router.handle("GET", "/tiles/default/1/0/0.json")
        assert status == 503
        assert json.loads(body)["cause"] == "upstream_unreachable"


class _SlowFastPair:
    """Two one-trick HTTP servers: ``slow`` stalls until released,
    ``fast`` answers immediately; distinct bodies tell who won."""

    def __init__(self):
        self.release = threading.Event()
        pair = self

        class Slow(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                pair.release.wait(5.0)
                self._answer(b'{"who": "slow"}')

            def log_message(self, *a):
                pass

            def _answer(self, body):
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass

        class Fast(Slow):
            def do_GET(self):
                self._answer(b'{"who": "fast"}')

        self.slow_server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), Slow)
        self.fast_server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), Fast)
        for s in (self.slow_server, self.fast_server):
            threading.Thread(target=s.serve_forever, daemon=True).start()

    def close(self):
        self.release.set()
        for s in (self.slow_server, self.fast_server):
            s.shutdown()
            s.server_close()


class TestHedging:
    def test_hedge_fires_past_the_latency_quantile_and_fast_wins(self):
        pair = _SlowFastPair()
        try:
            path = "/tiles/default/4/2/3.json"
            first, second = rendezvous_order(route_key(path), ["a", "b"])
            ports = {first: pair.slow_server.server_address[1],
                     second: pair.fast_server.server_address[1]}
            backends = [BackendClient(bid, "127.0.0.1", port)
                        for bid, port in ports.items()]
            router = RouterApp(backends, hedge_min_wait_s=0.01)
            for _ in range(64):
                router._latency.record(0.002)
            status, _, body, _, _, _ = router.handle("GET", path)
            assert (status, json.loads(body)["who"]) == (200, "fast")
            slow = next(b for b in backends if b.id == first)
            assert slow.breaker.state == CircuitBreaker.CLOSED
        finally:
            pair.close()

    def test_no_hedge_before_the_window_fills(self):
        pair = _SlowFastPair()
        try:
            path = "/tiles/default/4/2/3.json"
            first, second = rendezvous_order(route_key(path), ["a", "b"])
            ports = {first: pair.slow_server.server_address[1],
                     second: pair.fast_server.server_address[1]}
            router = RouterApp([BackendClient(bid, "127.0.0.1", port)
                                for bid, port in ports.items()])
            threading.Timer(0.2, pair.release.set).start()
            status, _, body, _, _, _ = router.handle("GET", path)
            assert (status, json.loads(body)["who"]) == (200, "slow")
        finally:
            pair.close()


class TestSupervisorRestart:
    def test_killed_backend_returns_to_the_ring(self, artifacts, tmp_path):
        log = obs.EventLog(str(tmp_path / "events.jsonl"))
        obs.set_event_log(log)
        sup = FleetSupervisor(
            None, 2, mode="thread",
            store_factory=lambda: TileStore(artifacts),
            cache_bytes=1 << 20, probe_interval_s=0.05,
            restart_base_s=0.05, restart_cap_s=0.2,
            monitor_interval_s=0.02)
        try:
            sup.start()
            server, base = serve_in_thread(sup.router)
            store = TileStore(artifacts)
            reference = ServeApp(store, TileCache(max_bytes=1 << 20))
            paths = _tile_paths(store, limit=8)
            for path in paths:
                assert _get(base + path)[0] == 200
            sup.kill_backend("b0")

            def cycle_done():
                kinds = [e["event"] for e in
                         obs.read_events(str(tmp_path / "events.jsonl"))
                         if e.get("backend") == "b0"]
                return ("fleet_backend_down" in kinds
                        and "fleet_backend_up" in kinds)

            assert _wait(cycle_done, 15.0), "no down/up event pair for b0"
            assert _wait(lambda: "b0" in json.loads(_get(
                base + "/healthz")[2])["fleet"]["eligible"])
            for path in paths:
                want = reference.handle("GET", path)
                status, _, body = _get(base + path)
                assert (status, body) == (want[0], want[2]), path
            server.shutdown()
            server.server_close()
        finally:
            sup.stop()
            obs.set_event_log(None)
            log.close()

    def test_mode_and_size_refusals_match_jax(self):
        from heatmap_tpu.serve.fleet import FleetSupervisor as JSup

        for args, kw in ((("x", 1), {"mode": "bogus"}),
                         ((None, 1), {"mode": "process"}),
                         (("x", 0), {"mode": "thread"})):
            msgs = []
            for cls in (FleetSupervisor, JSup):
                with pytest.raises(ValueError) as e:
                    cls(*args, **kw)
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1]


class TestFleetMetricsMerge:
    """``/metrics?fleet=1`` is ONE valid Prometheus document, and the
    merge equals the JAX package's on the same inputs."""

    BACKEND_TEXT = (
        "# HELP http_requests_total HTTP requests served\n"
        "# TYPE http_requests_total counter\n"
        'http_requests_total{route="tile",status="200"} 5\n'
        "# HELP serve_request_seconds Request latency\n"
        "# TYPE serve_request_seconds histogram\n"
        'serve_request_seconds_bucket{le="0.1"} 3\n'
        'serve_request_seconds_bucket{le="+Inf"} 5\n'
        "serve_request_seconds_sum 0.4\n"
        "serve_request_seconds_count 5\n"
    )

    @staticmethod
    def _scrape_parse(text):
        runs: dict[str, list[str]] = {}
        histograms = set()
        current = None

        def enter(family):
            nonlocal current
            if family != current:
                assert family not in runs, (
                    f"family {family!r} split into non-contiguous runs")
                runs[family] = []
                current = family

        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split()
                assert parts[1] in ("HELP", "TYPE"), line
                if parts[1] == "TYPE" and parts[3] == "histogram":
                    histograms.add(parts[2])
                enter(parts[2])
                continue
            name = line.split("{", 1)[0].split(" ", 1)[0]
            family = name
            for suffix in ("_bucket", "_sum", "_count"):
                base = name[: -len(suffix)]
                if name.endswith(suffix) and base in histograms:
                    family = base
            enter(family)
            runs[family].append(line)
        return runs

    def _router_with_fakes(self):
        text = self.BACKEND_TEXT

        class _Backend:
            def __init__(self, bid):
                self.id = bid

            def eligible(self):
                return True

            def fetch(self, method, path):
                return 200, {}, text.encode()

        router = RouterApp([])
        router.backends = {"b0": _Backend("b0"), "b1": _Backend("b1")}
        return router

    def test_merged_exposition_scrape_parses_with_router_registry(self):
        from heatmap_tpu_torch.serve.http import HTTP_REQUESTS

        obs.enable_metrics(True)
        HTTP_REQUESTS.inc(route="metrics", status="200")
        trouter.FLEET_REQUESTS.inc(backend="b0", outcome="ok")
        router = self._router_with_fakes()
        status, ctype, body, *_ = router.handle("GET", "/metrics?fleet=1")
        assert status == 200 and ctype.startswith("text/plain")
        runs = self._scrape_parse(body.decode())
        assert any('backend=' not in line
                   for line in runs["http_requests_total"])
        assert runs["fleet_requests_total"]
        for bid in ("b0", "b1"):
            assert any(f'backend="{bid}"' in line
                       for line in runs["http_requests_total"]), bid
            assert any(f'backend="{bid}"' in line
                       for line in runs["serve_request_seconds"]), bid
        kinds = {s.split("{", 1)[0].split(" ", 1)[0]
                 for s in runs["serve_request_seconds"]}
        assert {"serve_request_seconds_sum",
                "serve_request_seconds_count"} <= kinds

    def test_plain_metrics_unchanged_without_fleet_flag(self):
        obs.enable_metrics(True)
        trouter.FLEET_REQUESTS.inc(backend="b0", outcome="ok")
        status, _, body, *_ = self._router_with_fakes().handle("GET",
                                                               "/metrics")
        assert status == 200
        assert b"serve_request_seconds" not in body

    def test_merge_functions_equal_jax(self):
        own = ("# HELP http_requests_total HTTP requests served\n"
               "# TYPE http_requests_total counter\n"
               'http_requests_total{route="metrics",status="200"} 1\n'
               "# HELP fleet_requests_total Forward attempts\n"
               "# TYPE fleet_requests_total counter\n"
               'fleet_requests_total{backend="b0",outcome="ok"} 2\n')
        extra = "".join(trouter.relabel_metrics(self.BACKEND_TEXT,
                                                backend=b)
                        for b in ("b0", "b1"))
        assert extra == "".join(jrouter.relabel_metrics(self.BACKEND_TEXT,
                                                        backend=b)
                                for b in ("b0", "b1"))
        assert (trouter.merge_expositions(own, extra)
                == jrouter.merge_expositions(own, extra))


# -- process mode -----------------------------------------------------------


def _capture_argv(monkeypatch, backend):
    captured = {}

    class _Boom(Exception):
        pass

    def fake_popen(argv, **kwargs):
        captured["argv"] = argv
        captured["env"] = kwargs.get("env", {})
        raise _Boom

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    with pytest.raises(_Boom):
        backend.start()
    return captured


class TestProcessBackend:
    def test_argv_names_the_port_and_carries_telemetry_flags(
            self, tmp_path, monkeypatch):
        from heatmap_tpu_torch.serve.fleet import _ProcessBackend

        backend = _ProcessBackend(
            "b0", "arrays:/nonexistent", workdir=str(tmp_path),
            max_inflight=8, chaos="seed=3", slo_specs=["a:latency:p=0.9"],
            telemetry_opts={"interval": 2.5,
                            "watches": ["ingest_lag_seconds:z=6"]})
        captured = _capture_argv(monkeypatch, backend)
        argv = captured["argv"]
        assert argv[1:3] == ["-m", "heatmap_tpu_torch.serve.fleet"]
        assert argv[argv.index("--telemetry-sample-interval") + 1] == "2.5"
        assert argv[argv.index("--watch") + 1] == "ingest_lag_seconds:z=6"
        assert argv[argv.index("--max-inflight") + 1] == "8"
        assert argv[argv.index("--slo") + 1] == "a:latency:p=0.9"
        # The child finds this checkout's package first on its path.
        assert captured["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO

    def test_argv_equals_jax_but_for_the_module(self, tmp_path, monkeypatch):
        """Every option the supervisor forwards reaches the child as the
        JAX supervisor forwards it."""
        from heatmap_tpu.serve.fleet import _ProcessBackend as JBackend
        from heatmap_tpu_torch.serve.fleet import _ProcessBackend

        kw = dict(workdir=str(tmp_path), cache_bytes=1 << 20,
                  max_inflight=8, render_timeout_s=2.0, chaos="seed=3",
                  degrade_opts={"dwell_s": 1.0, "hold_s": 2.0,
                                "ladder_spec": "up=2"},
                  slo_specs=["a:latency:p=0.9"],
                  disk_cache_opts={"root": str(tmp_path / "dc"),
                                   "max_bytes": 1000},
                  prewarm_opts={"events": ["e.jsonl"], "top_k": 5},
                  telemetry_opts={"interval": 1.0, "watches": []})
        got = _capture_argv(monkeypatch, _ProcessBackend("b1", "x:y", **kw))
        want = _capture_argv(monkeypatch, JBackend("b1", "x:y", **kw))
        assert got["argv"][2] == "heatmap_tpu_torch.serve.fleet"
        assert want["argv"][2] == "heatmap_tpu.serve.fleet"
        assert got["argv"][3:] == want["argv"][3:]

    def test_no_telemetry_opts_means_no_forwarding(self):
        from heatmap_tpu_torch.serve.fleet import _ProcessBackend

        backend = _ProcessBackend("b0", "arrays:/nonexistent", workdir=".")
        assert backend._telemetry_opts is None

    def test_supervisor_plumbs_telemetry_opts_to_handles(self):
        sup = FleetSupervisor("arrays:/nonexistent", 1,
                              telemetry_opts={"interval": 1.0, "watches": []})
        sup._workdir = "."
        handle = sup._make_handle("b0")
        assert handle._telemetry_opts == {"interval": 1.0, "watches": []}


def test_backend_import_path_never_touches_cuda(artifacts):
    """A fleet child's whole life (imports, mount, requests) with every
    ``torch.cuda`` entry point booby-trapped: no call, no context."""
    script = f"""
import sys
import torch
calls = []
for name in ("init", "is_available", "device_count", "current_device",
             "synchronize", "set_device", "get_device_name"):
    def trap(*a, _n=name, **k):
        calls.append(_n)
        raise RuntimeError("cuda touched: " + _n)
    setattr(torch.cuda, name, trap)
from heatmap_tpu_torch.serve import fleet
from heatmap_tpu_torch.serve import ServeApp, TileCache, TileStore
app = ServeApp(TileStore({artifacts!r}), TileCache())
for p in ("/healthz", "/metrics", "/tiles/default/3/1/2.png",
          "/tiles/default/3/1/2.json"):
    app.handle("GET", p)
assert not calls, calls
assert not torch.cuda.is_initialized()
print("clean")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_process_fleet_of_two_serves_and_restarts(artifacts):
    """A real process-mode fleet of 2 over the small store: every tile
    through the router equals the single-process app, /healthz names
    both, and a SIGKILLed child is restarted and re-admitted."""
    store = TileStore(artifacts)
    reference = ServeApp(store, TileCache())
    obs.enable_metrics(True)
    sup = FleetSupervisor(artifacts, 2, probe_interval_s=0.05,
                          restart_base_s=0.05, restart_cap_s=0.5,
                          monitor_interval_s=0.02)
    try:
        sup.start()
        server, base = serve_in_thread(sup.router)
        try:
            health = json.loads(_get(base + "/healthz")[2])
            assert sorted(health["fleet"]["eligible"]) == ["b0", "b1"]
            pids = {bid: sup.backend(bid).proc.pid for bid in ("b0", "b1")}
            paths = _tile_paths(store, limit=8) + _tile_paths(
                store, limit=4, fmt="png")
            for path in paths:
                want = reference.handle("GET", path)
                status, headers, body = _get(base + path)
                assert (status, body, headers.get("ETag")) == (
                    want[0], want[2], want[3]), path
            os.kill(pids["b0"], signal.SIGKILL)
            for path in paths:  # no 500 while b0 is down
                assert _get(base + path)[0] in (200, 503)
            assert _wait(lambda: sup.backend("b0").alive()
                         and sup.backend("b0").proc.pid != pids["b0"])
            assert _wait(lambda: "b0" in json.loads(_get(
                base + "/healthz")[2])["fleet"]["eligible"])
            text = _get(base + "/metrics")[2].decode()
            assert 'fleet_backend_restarts_total{backend="b0"} 1' in text
            for path in paths:
                want = reference.handle("GET", path)
                assert _get(base + path)[2] == want[2], path
        finally:
            server.shutdown()
            server.server_close()
    finally:
        sup.stop()
    for pid in pids.values():
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
