"""Stateless fleet router: rendezvous hashing + the robustness stack
(the port's copy of heatmap_tpu/serve/router.py).

The router is the thin frontend of the serve fleet (``serve/fleet.py``
spawns the backends). It owns no tile state — every decision is a pure
function of the request key and the live ring — so any number of
router processes could front the same fleet. Placement uses
**rendezvous (HRW) hashing** on the tile key ``layer/z/x/y`` (format
excluded, so a tile's .png and .json land on the same backend and
share its LRU locality) with **bounded-load spill**: when the
top-ranked backend is at its in-flight cap the request spills to the
next-ranked one instead of queueing behind a hot key (the
consistent-hashing-with-bounded-load construction, arXiv:1608.01350).

Robustness machinery, in the order a request meets it:

- **Admission control**: per-backend in-flight bound; a request that
  cannot find a slot within ``queue_deadline_s`` is shed with a typed
  503 + ``Retry-After`` — never a 500, and never an unbounded queue.
- **Circuit breakers** (closed → open → half-open): passive signals
  (connection failures, HTTP 5xx) open a backend's breaker after
  ``fail_threshold`` consecutive failures; cooldowns escalate per
  episode with seeded jitter (same ``hash01`` shape as
  ``faults/retry.py`` backoff, scaled by the installed plane's
  ``backoff_scale``). Open backends leave the ring; the prober's
  half-open trial probe re-admits them. Ring edges are emitted as
  ``fleet_backend_down`` / ``fleet_backend_up`` events — one pair per
  outage, not one per failed request.
- **Hedged reads** ("The Tail at Scale"): once the latency window has
  enough samples, a request still unanswered past the
  ``hedge_quantile`` latency fires a duplicate on the next replica in
  rendezvous order; first response wins and the loser's connection is
  closed (cancelled losers never feed the breaker).
- **One-retry-on-next-replica**: a connection failure (including an
  injected ``router.forward`` fault) burns the single retry from the
  ``POLICIES`` table and lands on the next eligible replica — the
  failover is the backoff, a request handler never sleeps.

Byte-equality contract: everything that is not a router-owned
endpoint (``/healthz``, ``/metrics``, ``/series``, ``/dashboard``,
``/reload``, ``/fleet/*``) is
forwarded verbatim — status, body, ETag, and ``If-None-Match``
revalidation all come from an ordinary ``ServeApp`` backend, so a
fleet response is byte-identical to a single process no matter which
path (direct, spilled, hedged, retried, mid-drain) produced it.
``RouterApp.handle`` returns the same 6-tuple as ``ServeApp.handle``
and is served by the same ``_Handler``/``make_server`` shell.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import queue
import re
import threading
import time
import urllib.parse
from collections import deque

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.obs import anomaly, incident, timeseries, tracing
from heatmap_tpu_torch.serve import dashboard as dashboard_mod
from heatmap_tpu_torch.serve import degrade as degrade_mod
from heatmap_tpu_torch.serve.http import _TILE_RE, Response, local_series_response

_registry = obs.get_registry()
FLEET_REQUESTS = _registry.counter(
    "fleet_requests_total", "Forward attempts by the fleet router",
    labelnames=("backend", "outcome"))
FLEET_ROUTED = _registry.counter(
    "fleet_routed_total", "Requests routed, by placement path",
    labelnames=("path",))
FLEET_HEDGES = _registry.counter(
    "fleet_hedges_total", "Hedged duplicate requests launched",
    labelnames=("outcome",))
FLEET_SHED = _registry.counter(
    "fleet_shed_total", "Requests shed by router admission control",
    labelnames=("cause",))
FLEET_BACKEND_STATE = _registry.gauge(
    "fleet_backend_state",
    "Breaker state per backend (0 closed, 1 half-open, 2 open)",
    labelnames=("backend",))
FLEET_INFLIGHT = _registry.gauge(
    "fleet_inflight_requests", "In-flight forwards per backend",
    labelnames=("backend",))
FLEET_RESTARTS = _registry.counter(
    "fleet_backend_restarts_total", "Backend restarts by the supervisor",
    labelnames=("backend",))

# Connection-level failures that trigger failover to the next replica.
# HTTP status codes are NOT in this set: a backend's typed 503 passes
# through to the client untouched (it is an answer, not an absence).
_CONN_ERRORS = (OSError, http.client.HTTPException, faults.InjectedFault)

_STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


def rendezvous_order(key: str, backend_ids) -> list:
    """Backends ranked by highest-random-weight for ``key``.

    A pure function of ``(key, set(backend_ids))``: removing one
    backend only moves the keys it owned (everyone else's ranking is
    untouched), and two routers with the same ring place identically —
    which is what makes replays and the byte-equality pin exact.
    """
    def score(bid):
        digest = hashlib.blake2b(f"{bid}|{key}".encode(),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "big")

    return sorted(backend_ids, key=lambda bid: (-score(bid), bid))


def route_key(path: str) -> str:
    """The placement key for a request path: ``layer/z/x/y`` for tiles
    (format stripped, so .png and .json colocate), ``query:layer/z/bbox``
    for /query (op/k/q excluded, so repeated analytics of the same
    region — sum, then top-k, then a quantile — land on one backend and
    share its LRU locality), the raw path otherwise. For tiles the
    query string is excluded, so ``?synopsis=1`` and the exact tile
    colocate too."""
    bare, _, query = path.partition("?")
    m = _TILE_RE.match(bare)
    if m is not None:
        return f"{m['layer']}/{m['z']}/{m['x']}/{m['y']}"
    if bare == "/query":
        params = urllib.parse.parse_qs(query) if query else {}

        def last(name, default=""):
            vals = params.get(name)
            return vals[-1] if vals else default

        return (f"query:{last('layer', 'default')}/{last('z')}/"
                f"{last('bbox')}")
    return path


def _flag_opt(query: str, name: str) -> bool:
    """Boolean query option (last value wins, urllib convention)."""
    if not query:
        return False
    vals = urllib.parse.parse_qs(query).get(name)
    if not vals:
        return False
    return vals[-1] not in ("0", "false", "no")


# One exposition sample line: name, optional {labels}, rest (value and
# any OpenMetrics exemplar suffix — which carries its own {...} and
# must not be touched by the relabel).
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?(?P<rest> .*)$")


def relabel_metrics(text: str, **extra_labels) -> str:
    """Inject labels (e.g. ``backend="b0"``) into every sample line of
    a Prometheus text exposition. HELP/TYPE comment lines pass through
    unchanged — :func:`merge_expositions` dedupes them so the merged
    fleet page keeps one header block per metric family (the scraping
    router's own when it shares the family, else one adopted from the
    first backend that exposes it)."""
    injected = ",".join(f'{k}="{v}"' for k, v in sorted(
        extra_labels.items()))
    out = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        labels = m["labels"]
        merged = f"{injected},{labels}" if labels else injected
        out.append(f"{m['name']}{{{merged}}}{m['rest']}")
    return "\n".join(out) + ("\n" if out else "")


def merge_expositions(own: str, extra: str) -> str:
    """Fold relabeled backend sample lines into the router's own
    exposition, grouped by metric family. Naively concatenating the
    per-backend chunks after the router's page puts the same family
    (``http_requests_total`` on the router shell AND on every backend)
    in non-contiguous runs — which strict Prometheus text parsers
    reject, silently costing the scrape the router's own registry
    (``fleet_*``, its shell's ``http_requests_total``). Here every
    family appears exactly once: the router's HELP/TYPE block and own
    samples first, backend-labeled samples appended inside the same
    block, backend-only families as new blocks at the end (pinned by
    the scrape-parse test in tests/test_torch_fleet.py)."""
    families: list = []     # (family, header_lines, sample_lines)
    by_family: dict = {}

    def _group(name):
        entry = by_family.get(name)
        if entry is None:
            entry = (name, [], [])
            families.append(entry)
            by_family[name] = entry
        return entry

    current = None
    for line in own.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            name = line.split(" ", 3)[2]
            current = _group(name)
            current[1].append(line)
        elif line:
            m = _SAMPLE_RE.match(line)
            if current is None or (m is not None
                                   and not m["name"].startswith(
                                       current[0])):
                current = _group(m["name"] if m is not None else line)
            current[2].append(line)
    # Histogram families expose suffixed sample names; map them back so
    # a backend's _bucket lines land inside the family's block.
    sample_to_family = {}
    for name, _header, _samples in families:
        sample_to_family[name] = name
        for suffix in ("_bucket", "_sum", "_count"):
            sample_to_family[name + suffix] = name
    for line in extra.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            # Backend-only family: adopt its header block (one copy —
            # every backend chunk repeats it) so suffixed histogram
            # samples still parse as ONE typed family downstream.
            name = line.split(" ", 3)[2]
            family = sample_to_family.get(name)
            if family is None:
                family = name
                for sname in (name, name + "_bucket", name + "_sum",
                              name + "_count"):
                    sample_to_family.setdefault(sname, family)
            entry = _group(family)
            kind = line.split(" ", 2)[1]
            if not any(h.split(" ", 2)[1] == kind for h in entry[1]):
                entry[1].append(line)
            continue
        m = _SAMPLE_RE.match(line) if line else None
        if m is None:
            continue
        family = sample_to_family.get(m["name"])
        if family is None:
            family = m["name"]
            for suffix in ("_bucket", "_sum", "_count"):
                if family.endswith(suffix):
                    family = family[:-len(suffix)]
                    break
            for sname in (family, family + "_bucket", family + "_sum",
                          family + "_count"):
                sample_to_family.setdefault(sname, family)
        _group(family)[2].append(line)
    out = []
    for _name, header, samples in families:
        out.extend(header)
        out.extend(samples)
    return "\n".join(out) + ("\n" if out else "")


class CircuitBreaker:
    """Per-backend breaker: closed → open → half-open.

    ``fail_threshold`` consecutive failures open it; the open cooldown
    escalates per episode (``open_base_s * 2**(episode-1)``, capped)
    with seeded jitter in [0.5, 1.0) of the nominal — the
    ``faults/retry.py`` backoff shape, deterministic under the
    installed plane's seed and scaled by its ``backoff_scale``. After
    the cooldown a single half-open trial is handed out
    (``admits_trial``); success closes the breaker and resets the
    escalation, failure re-opens with a longer cooldown.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, backend_id: str, *, fail_threshold: int = 3,
                 open_base_s: float = 0.25, open_cap_s: float = 15.0,
                 clock=time.monotonic):
        self.backend_id = backend_id
        self.fail_threshold = fail_threshold
        self.open_base_s = open_base_s
        self.open_cap_s = open_cap_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._episode = 0  # open episodes since the last close
        self._open_until = 0.0
        self._trial_out = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    def _peek_state(self) -> str:
        if self._state == self.OPEN and self._clock() >= self._open_until:
            return self.HALF_OPEN
        return self._state

    def admits(self) -> bool:
        """True only when closed — the ring membership test. Half-open
        trials go through ``admits_trial`` (the prober), so regular
        traffic never lands on a suspect backend."""
        with self._lock:
            return self._state == self.CLOSED

    def admits_trial(self) -> bool:
        """Hand out the single half-open trial once the cooldown has
        expired (or pass the regular health check while closed)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._clock() < self._open_until:
                return False
            if self._state == self.OPEN:
                self._state = self.HALF_OPEN
                self._trial_out = False
            if not self._trial_out:
                self._trial_out = True
                return True
            return False

    def record_success(self) -> bool:
        """Returns True on the re-close edge (open/half-open → closed)."""
        with self._lock:
            reclosed = self._state != self.CLOSED
            self._state = self.CLOSED
            self._consecutive = 0
            self._episode = 0
            self._trial_out = False
            return reclosed

    def record_failure(self, *, force: bool = False) -> bool:
        """Returns True on the closed → open edge (the start of an
        outage episode; half-open → open re-opens silently). ``force``
        opens immediately regardless of the threshold (supervisor saw
        the process die)."""
        with self._lock:
            was_closed = self._state == self.CLOSED
            self._consecutive += 1
            if (was_closed and not force
                    and self._consecutive < self.fail_threshold):
                return False
            self._episode += 1
            self._state = self.OPEN
            self._trial_out = False
            self._open_until = self._clock() + self._cooldown_s()
            self._consecutive = 0
            return was_closed

    def _cooldown_s(self) -> float:
        plane = faults.get_plane()
        seed = plane.seed if plane is not None else 0
        scale = plane.backoff_scale if plane is not None else 1.0
        nominal = min(self.open_cap_s,
                      self.open_base_s * 2.0 ** (self._episode - 1))
        jitter = 0.5 + 0.5 * faults.hash01(
            seed, "breaker", self.backend_id, self._episode)
        return nominal * jitter * scale


class BackendClient:
    """One backend's address, connection pool, breaker, and ring flags.

    Pooled keep-alive connections are invalidated wholesale when the
    supervisor restarts the backend on a new port (``set_address``
    bumps the epoch). A request on a stale pooled connection gets one
    silent same-backend retry on a fresh connection before the failure
    counts — a keep-alive the server closed between requests is not a
    backend fault.
    """

    def __init__(self, backend_id: str, host: str, port: int, *,
                 timeout_s: float = 10.0, breaker: CircuitBreaker | None = None):
        self.id = backend_id
        self.timeout_s = timeout_s
        self.breaker = breaker or CircuitBreaker(backend_id)
        self.draining = False
        self.ejected: str | None = None  # cause; non-None = out of the ring
        self.inflight = 0  # guarded by the router's slot condition
        self.down_announced = False  # guards the down/up event pair
        # Last brownout snapshot the prober read from this backend's
        # /healthz (serve/degrade.py); None until one is seen.
        self.degrade: dict | None = None
        # Last prewarm summary from the same probe (tilefs/prewarm.py);
        # lets operators check cache warm-up fleet-wide from the router.
        self.prewarm: dict | None = None
        self._lock = threading.Lock()
        self._host, self._port = host, int(port)
        self._epoch = 0
        self._pool: list = []

    @property
    def address(self) -> str:
        with self._lock:
            return f"{self._host}:{self._port}"

    def set_address(self, host: str, port: int):
        with self._lock:
            self._host, self._port = host, int(port)
            self._epoch += 1
            stale, self._pool = self._pool, []
        for conn in stale:
            conn.close()

    def eligible(self) -> bool:
        return (not self.draining and self.ejected is None
                and self.breaker.admits())

    def _acquire(self, fresh: bool = False):
        with self._lock:
            if not fresh and self._pool:
                return self._pool.pop(), False, self._epoch
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self.timeout_s)
            return conn, True, self._epoch

    def _release(self, conn, epoch: int, reusable: bool):
        if reusable:
            with self._lock:
                if epoch == self._epoch and len(self._pool) < 8:
                    self._pool.append(conn)
                    return
        conn.close()

    def fetch(self, method: str, path: str, headers: dict | None = None,
              *, conn_box: dict | None = None):
        """One HTTP round-trip: ``(status, headers, body)``. Raises
        ``_CONN_ERRORS`` members on connection-level failure. When
        ``conn_box`` is given, the live connection is published there
        so a hedging winner can cancel this attempt by closing it."""
        conn, fresh, epoch = self._acquire()
        try:
            return self._roundtrip(conn, epoch, method, path, headers,
                                   conn_box)
        except (OSError, http.client.HTTPException):
            conn.close()
            if fresh or (conn_box is not None and conn_box.get("cancelled")):
                raise
            # Stale pooled keep-alive: one silent fresh-conn retry.
            conn, _, epoch = self._acquire(fresh=True)
            try:
                return self._roundtrip(conn, epoch, method, path, headers,
                                       conn_box)
            except (OSError, http.client.HTTPException):
                conn.close()
                raise

    def _roundtrip(self, conn, epoch, method, path, headers, conn_box):
        if conn_box is not None:
            conn_box["conn"] = conn
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        body = resp.read()
        reusable = not resp.will_close and (conn_box is None
                                            or not conn_box.get("cancelled"))
        self._release(conn, epoch, reusable)
        return resp.status, dict(resp.getheaders()), body


class _LatencyWindow:
    """Ring buffer of recent forward latencies; the hedge trigger."""

    def __init__(self, maxlen: int = 512, min_samples: int = 32):
        self._lock = threading.Lock()
        self._window = deque(maxlen=maxlen)
        self.min_samples = min_samples

    def record(self, seconds: float):
        with self._lock:
            self._window.append(seconds)

    def quantile(self, q: float) -> float | None:
        with self._lock:
            if len(self._window) < self.min_samples:
                return None
            ordered = sorted(self._window)
        idx = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[idx]


class RouterApp:
    """Transport-free router core: same ``handle()`` contract as
    ``ServeApp``, served by the same HTTP shell (``make_server``)."""

    def __init__(self, backends, *, max_inflight: int = 32,
                 queue_deadline_s: float = 0.25,
                 hedge_quantile: float = 0.95,
                 hedge_min_wait_s: float = 0.005,
                 probe_interval_s: float = 1.0,
                 retry_after_s: float = 1.0,
                 clock=time.monotonic):
        self.backends: dict[str, BackendClient] = {b.id: b for b in backends}
        self.max_inflight = max_inflight
        self.queue_deadline_s = queue_deadline_s
        self.hedge_quantile = hedge_quantile
        self.hedge_min_wait_s = hedge_min_wait_s
        self.probe_interval_s = probe_interval_s
        self.retry_after_s = retry_after_s
        self._clock = clock
        self._slot_cond = threading.Condition()
        self._latency = _LatencyWindow()
        self._retry_budget = faults.policy_for("router.forward").retries
        self._stop = threading.Event()
        self._prober: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Start the active health prober (half-open re-admission)."""
        if self._prober is None:
            self._stop.clear()
            self._prober = threading.Thread(
                target=self._probe_loop, name="fleet-prober", daemon=True)
            self._prober.start()
        return self

    def close(self):
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
            self._prober = None

    # -- ring membership events --------------------------------------------

    def _announce_down(self, backend: BackendClient, reason: str,
                       detail: str = ""):
        if obs.metrics_enabled():
            FLEET_BACKEND_STATE.set(
                _STATE_VALUE.get(backend.breaker.state, 2),
                backend=backend.id)
        if not backend.down_announced:
            backend.down_announced = True
            obs.emit("fleet_backend_down", backend=backend.id, reason=reason,
                     **({"detail": detail} if detail else {}))

    def _announce_up(self, backend: BackendClient):
        if obs.metrics_enabled():
            FLEET_BACKEND_STATE.set(0, backend=backend.id)
        if (backend.down_announced and backend.ejected is None
                and backend.breaker.state == CircuitBreaker.CLOSED):
            backend.down_announced = False
            obs.emit("fleet_backend_up", backend=backend.id)

    def note_failure(self, backend: BackendClient, reason: str,
                     detail: str = "", *, force: bool = False):
        if backend.breaker.record_failure(force=force):
            self._announce_down(backend, reason, detail)

    def note_success(self, backend: BackendClient):
        if backend.breaker.record_success():
            self._announce_up(backend)

    # -- prober ------------------------------------------------------------

    def _probe_loop(self):
        while not self._stop.wait(self.probe_interval_s):
            for backend in list(self.backends.values()):
                if self._stop.is_set():
                    return
                if backend.draining or not backend.breaker.admits_trial():
                    continue
                self._probe_once(backend)

    def _probe_once(self, backend: BackendClient) -> bool:
        try:
            faults.check("backend.probe", key=backend.id)
            status, _, body = backend.fetch("GET", "/healthz")
            ok = status == 200
        except Exception:
            ok = False
            body = b""
        if ok:
            self.note_success(backend)
            # Probe piggyback: read the backend's brownout ladder state
            # so the router agrees fleet-wide on the active rung
            # without a second endpoint or any push machinery.
            try:
                health = json.loads(body)
            except (ValueError, AttributeError):
                health = {}
            if not isinstance(health, dict):
                health = {}
            snap = health.get("degrade")
            backend.degrade = snap if isinstance(snap, dict) else None
            warm = health.get("prewarm")
            backend.prewarm = warm if isinstance(warm, dict) else None
        else:
            self.note_failure(backend, "probe")
        return ok

    # -- request core ------------------------------------------------------

    def handle(self, method: str, path: str,
               if_none_match: str | None = None):
        """Same 6-tuple contract as ``ServeApp.handle``."""
        # Router-owned endpoints match on the bare path so a query
        # string (``/metrics?fleet=1``) selects options instead of
        # falling through to the placement ring.
        bare, _, query = path.partition("?")
        if method == "GET" and bare == "/healthz":
            body = json.dumps(self._health(), indent=2).encode()
            return 200, "application/json", body, None, "healthz", None
        if method == "GET" and bare == "/metrics":
            obs.refresh_process_gauges()
            text = _registry.render_prometheus()
            if _flag_opt(query, "fleet"):
                # Family-grouped merge: the router's own registry and
                # every backend's samples in one parse-valid exposition
                # (a plain concat puts shared families in
                # non-contiguous runs, which strict scrapers reject).
                text = merge_expositions(text, self._fleet_metrics())
            body = text.encode()
            return (200, "text/plain; version=0.0.4", body, None,
                    "metrics", None)
        if method == "GET" and bare == "/series":
            return self._handle_series(query)
        if method == "GET" and bare == "/dashboard":
            body = dashboard_mod.render_page(title="heatmap-tpu fleet ops")
            return (200, "text/html; charset=utf-8", body, None,
                    "dashboard", None)
        if method == "POST" and bare == "/reload":
            return self._rolling_reload()
        if method == "POST" and bare.startswith("/fleet/"):
            return self._fleet_op(bare)
        return self._route(method, path, if_none_match)

    def _fleet_metrics(self) -> str:
        """Scrape each live backend's ``/metrics`` and merge the series
        under a ``backend`` label next to the router's own registry
        (``GET /metrics?fleet=1``). Unreachable backends are skipped —
        a scrape must never trip breakers or block on a dead ring
        member beyond the client timeout."""
        chunks = []
        for bid in sorted(self.backends):
            backend = self.backends[bid]
            if not backend.eligible():
                continue
            try:
                status, _, body = backend.fetch("GET", "/metrics")
            except Exception:
                continue
            if status != 200:
                continue
            chunks.append(relabel_metrics(
                body.decode("utf-8", "replace"), backend=bid))
        return "".join(chunks)

    def _handle_series(self, query: str):
        """``GET /series`` router-side: the router's own telemetry
        store through the same parser as ServeApp, and — under
        ``?fleet=1``, the ``/metrics?fleet=1`` fan-out shape — each
        live backend's frames merged in, stamped with a ``backend``
        label (router-own frames stamped ``"router"``). Unreachable
        backends are skipped, never a 5xx: a dashboard poll must not
        trip breakers or fail on a dead ring member."""
        result = local_series_response(query)
        status, ctype, body, etag, route, cache = result
        if status != 200 or not _flag_opt(query, "fleet"):
            return result
        doc = json.loads(body)
        frames = doc.get("frames") or []
        for frame in frames:
            frame["backend"] = "router"
        enabled = bool(doc.get("enabled"))
        for bid in sorted(self.backends):
            backend = self.backends[bid]
            if not backend.eligible():
                continue
            try:
                b_status, _, b_body = backend.fetch(
                    "GET", f"/series?{query}")
            except Exception:
                continue
            if b_status != 200:
                continue
            try:
                b_doc = json.loads(b_body)
            except ValueError:
                continue
            for frame in b_doc.get("frames") or []:
                frame["backend"] = bid
                frames.append(frame)
            enabled = enabled or bool(b_doc.get("enabled"))
        doc["frames"] = frames
        doc["enabled"] = enabled
        if enabled:
            doc.pop("detail", None)  # at least one sampler is on
        body = json.dumps(doc, sort_keys=True).encode()
        return 200, "application/json", body, None, "series", None

    # -- routing -----------------------------------------------------------

    def _shed(self, cause: str, detail: str = "", status: int = 503):
        if obs.metrics_enabled():
            FLEET_SHED.inc(cause=cause)
        if status == 503:
            # Router-side typed 503s are incident trigger edges too
            # (rate-limited per kind by the manager).
            incident.trigger("shed", detail=cause)
        body = json.dumps({"error": "service unavailable", "cause": cause,
                           **({"detail": detail} if detail else {})}).encode()
        return status, "application/json", body, None, "shed", None

    def fleet_degrade(self) -> dict | None:
        """Fleet-wide brownout agreement: the hottest backend's ladder
        snapshot (max rung wins — one overloaded ring member is enough
        to start protecting it). None until a probe has seen one."""
        hottest = None
        for backend in self.backends.values():
            snap = backend.degrade
            if snap is None:
                continue
            if hottest is None or snap.get("rung", 0) > hottest.get(
                    "rung", 0):
                hottest = snap
        return hottest

    def _route(self, method, path, if_none_match):
        key = route_key(path)
        snap = self.fleet_degrade()
        if snap is not None and snap.get("rung", 0) >= snap.get(
                "max_rung", degrade_mod.MAX_RUNG):
            # Top rung somewhere in the ring: apply the backends' own
            # deterministic key shed router-side, before spending a
            # forward slot — the seeded hash agrees with every backend,
            # so the router sheds exactly the keys they would.
            m = _TILE_RE.match(path.partition("?")[0])
            if m is not None and degrade_mod.shed_tile(
                    float(snap.get("shed_fraction", 0.0)),
                    (m["layer"], m["z"], m["x"], m["y"], m["fmt"])):
                return self._shed(
                    "brownout", f"fleet rung {snap.get('rung')}")
        order = [self.backends[bid] for bid in
                 rendezvous_order(key, list(self.backends))]
        primary, rank = self._admit(order)
        if primary is None:
            if rank < 0:
                return self._shed("no_backends",
                                  "no eligible backend in the ring")
            return self._shed("overload",
                              f"no slot within {self.queue_deadline_s}s")
        placement = "direct" if rank == 0 else "spill"
        if obs.metrics_enabled():
            FLEET_ROUTED.inc(path=placement)
        return self._forward(method, path, if_none_match, order, primary)

    def _admit(self, order):
        """Claim an in-flight slot on the best-ranked eligible backend,
        spilling down the rendezvous order past saturated ones; block
        up to the queue deadline for a slot. Returns ``(backend, rank)``
        or ``(None, -1)`` when the ring is empty / ``(None, 0)`` on
        queue-deadline overload."""
        deadline = self._clock() + self.queue_deadline_s
        with self._slot_cond:
            while True:
                any_eligible = False
                for rank, backend in enumerate(order):
                    if not backend.eligible():
                        continue
                    any_eligible = True
                    if backend.inflight < self.max_inflight:
                        self._claim_locked(backend)
                        return backend, rank
                if not any_eligible:
                    return None, -1
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return None, 0
                self._slot_cond.wait(remaining)

    def _claim_locked(self, backend):
        backend.inflight += 1
        if obs.metrics_enabled():
            FLEET_INFLIGHT.set(backend.inflight, backend=backend.id)

    def _claim_extra(self, order, used):
        """Claim the next-ranked eligible, under-cap backend not in
        ``used`` (hedge / retry target); None when the ring is spent."""
        with self._slot_cond:
            for backend in order:
                if (backend.id not in used and backend.eligible()
                        and backend.inflight < self.max_inflight):
                    self._claim_locked(backend)
                    return backend
        return None

    def _release_slot(self, backend):
        with self._slot_cond:
            backend.inflight -= 1
            if obs.metrics_enabled():
                FLEET_INFLIGHT.set(backend.inflight, backend=backend.id)
            self._slot_cond.notify_all()

    def _forward(self, method, path, if_none_match, order, primary):
        headers = {}
        if if_none_match is not None:
            headers["If-None-Match"] = if_none_match
        traceparent = tracing.current_traceparent()
        if traceparent is not None:
            headers["traceparent"] = traceparent

        outcomes: queue.SimpleQueue = queue.SimpleQueue()
        boxes: dict[str, dict] = {}
        used = {primary.id}
        live = [0]

        def attempt_run(backend, kind):
            box = {"conn": None, "cancelled": False}
            boxes[backend.id] = box
            live[0] += 1

            def run():
                t0 = self._clock()
                try:
                    faults.check("router.forward", key=backend.id)
                    result = backend.fetch(method, path, headers,
                                           conn_box=box)
                    outcomes.put((kind, backend, result, None,
                                  self._clock() - t0))
                except Exception as exc:
                    outcomes.put((kind, backend, None, exc,
                                  self._clock() - t0))
                finally:
                    self._release_slot(backend)

            threading.Thread(target=tracing.context_bound(run),
                             name=f"fleet-fwd-{backend.id}",
                             daemon=True).start()

        attempt_run(primary, "primary")
        hedge_at = None
        hedge_q = self._latency.quantile(self.hedge_quantile)
        if hedge_q is not None:
            hedge_at = self._clock() + max(self.hedge_min_wait_s, hedge_q)
        retries_used = 0
        last_exc: Exception | None = None

        while live[0] > 0:
            timeout = None
            if hedge_at is not None:
                timeout = max(0.0, hedge_at - self._clock())
            try:
                kind, backend, result, exc, dt = outcomes.get(
                    timeout=timeout)
            except queue.Empty:
                # Hedge timer fired with no answer yet: duplicate the
                # request on the next replica in rendezvous order.
                hedge_at = None
                extra = self._claim_extra(order, used)
                if extra is not None:
                    used.add(extra.id)
                    if obs.metrics_enabled():
                        FLEET_ROUTED.inc(path="hedge")
                    attempt_run(extra, "hedge")
                continue
            live[0] -= 1
            box = boxes.get(backend.id, {})
            if box.get("cancelled"):
                continue  # loser of a hedge race; already answered
            if exc is None:
                status = result[0]
                if status >= 500:
                    # An answer, but also a passive breaker signal; a
                    # typed 503 passes through rather than failing over
                    # (it is load shedding, not absence).
                    self.note_failure(backend, f"http_{status}")
                else:
                    self.note_success(backend)
                    self._latency.record(dt)
                if obs.metrics_enabled():
                    FLEET_REQUESTS.inc(backend=backend.id, outcome="ok")
                    if kind == "hedge":
                        FLEET_HEDGES.inc(outcome="win")
                self._cancel_others(boxes, backend.id)
                return self._relay(path, result)
            # Connection-level failure: feed the breaker, fail over.
            last_exc = exc
            self.note_failure(backend, "connect", repr(exc))
            if obs.metrics_enabled():
                FLEET_REQUESTS.inc(backend=backend.id, outcome="error")
                if kind == "hedge":
                    FLEET_HEDGES.inc(outcome="lose")
            if live[0] == 0 and retries_used < self._retry_budget:
                extra = self._claim_extra(order, used)
                if extra is not None:
                    retries_used += 1
                    used.add(extra.id)
                    if obs.metrics_enabled():
                        FLEET_ROUTED.inc(path="retry")
                    attempt_run(extra, "retry")
        return self._shed("upstream_unreachable",
                          repr(last_exc) if last_exc else "")

    def _cancel_others(self, boxes, winner_id):
        for backend_id, box in boxes.items():
            if backend_id == winner_id:
                continue
            box["cancelled"] = True
            conn = box.get("conn")
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass

    def _relay(self, path, result):
        status, resp_headers, body = result
        etag = resp_headers.get("ETag")
        ctype = resp_headers.get("Content-Type", "application/octet-stream")
        route = ("tiles" if _TILE_RE.match(path.partition("?")[0])
                 else "proxy")
        forwarded = {
            name: resp_headers[name]
            for name in ("X-Heatmap-Synopsis", "X-Heatmap-Query-Error")
            if resp_headers.get(name) is not None}
        if forwarded:
            # Part of the byte-equality contract: the error annotations
            # a backend stamped must survive the fleet hop.
            return Response(status, ctype, body, etag, route, None,
                            headers=forwarded)
        return status, ctype, body, etag, route, None

    # -- fleet operations --------------------------------------------------

    def _fleet_op(self, path):
        parts = path.strip("/").split("/")
        # /fleet/{backend_id}/drain | undrain
        if len(parts) != 3 or parts[2] not in ("drain", "undrain"):
            body = json.dumps({"error": "not found", "path": path}).encode()
            return 404, "application/json", body, None, "fleet", None
        backend = self.backends.get(parts[1])
        if backend is None:
            body = json.dumps({"error": "unknown backend", "backend": parts[1],
                               "backends": sorted(self.backends)}).encode()
            return 404, "application/json", body, None, "fleet", None
        if parts[2] == "drain":
            backend.draining = True
            # Forward so the backend itself sheds direct traffic too;
            # best-effort (the router-side flag already pulls it from
            # the ring even if the backend is unreachable).
            detail = self._forward_op(backend, "POST", "/drain")
        else:
            backend.draining = False
            detail = self._forward_op(backend, "POST", "/undrain")
        body = json.dumps({"backend": backend.id,
                           "draining": backend.draining,
                           "inflight": backend.inflight,
                           "backend_response": detail}).encode()
        return 200, "application/json", body, None, "fleet", None

    def _forward_op(self, backend, method, path):
        try:
            status, _, body = backend.fetch(method, path)
            try:
                payload = json.loads(body)
            except ValueError:
                payload = body.decode("utf-8", "replace")
            return {"status": status, "body": payload}
        except Exception as exc:
            return {"error": repr(exc)}

    def _rolling_reload(self):
        """Rolling ``/reload`` across the fleet, atomic per backend: a
        backend that fails reload keeps its last-good index (single
        process semantics) and stays **ejected** from the ring rather
        than serving a mixed generation; the next successful rolling
        reload re-admits it."""
        results = {}
        all_ok = True
        for backend in list(self.backends.values()):
            backend.ejected = "reloading"
            outcome = self._forward_op(backend, "POST", "/reload")
            if outcome.get("status") == 200:
                backend.ejected = None
                results[backend.id] = {"ok": True, **outcome}
                self._announce_up(backend)
            else:
                backend.ejected = "reload_failed"
                results[backend.id] = {"ok": False, **outcome}
                all_ok = False
                self._announce_down(
                    backend, "reload_failed",
                    json.dumps(outcome.get("body", outcome.get("error", ""))))
        status = 200 if all_ok else 503
        body = json.dumps({"ok": all_ok, "backends": results}).encode()
        return status, "application/json", body, None, "reload", None

    # -- health ------------------------------------------------------------

    def _health(self) -> dict:
        states = {}
        for backend in self.backends.values():
            states[backend.id] = {
                "address": backend.address,
                "breaker": backend.breaker.state,
                "inflight": backend.inflight,
                "draining": backend.draining,
                "ejected": backend.ejected,
                "eligible": backend.eligible(),
            }
            if backend.degrade is not None:
                states[backend.id]["degrade_rung"] = backend.degrade.get(
                    "rung", 0)
            if backend.prewarm is not None:
                states[backend.id]["prewarm"] = backend.prewarm
        eligible = [bid for bid, st in states.items() if st["eligible"]]
        doc = {
            "role": "router",
            "status": "ok" if eligible else "degraded",
            "fleet": {
                "size": len(self.backends),
                "eligible": eligible,
                "backends": states,
            },
            "admission": {
                "max_inflight": self.max_inflight,
                "queue_deadline_s": self.queue_deadline_s,
            },
        }
        snap = self.fleet_degrade()
        if snap is not None:
            # The agreed fleet-wide ladder state (max rung across the
            # ring) — what operators and upstream layers should read.
            doc["degrade"] = snap
        # Router-process telemetry + anomaly state, when armed — the
        # dashboard served off the router reads these chips.
        ts_store = timeseries.get_store()
        if ts_store is not None:
            doc["telemetry"] = ts_store.stats()
        engine = anomaly.get_engine()
        if engine is not None:
            doc["anomalies"] = engine.recent(16)
        return doc
