"""Stdlib HTTP frontend: ThreadingHTTPServer over store + cache.

The port's copy of heatmap_tpu/serve/http.py for one process: every
route answers with the JAX package's status, body and ETag over the
same store, temporal folds (``?as_of=/window=/decay=`` tiles and
``/query?op=topk_growth``) included.

Routes:

- ``GET /tiles/{layer}/{z}/{x}/{y}.png``  — colormapped tile image
- ``GET /tiles/{layer}/{z}/{x}/{y}.json`` — reference-compatible counts
- ``?synopsis=1`` on a tile URL opts into the wavelet-synopsis path
  (docs/synopsis.md): when the source zoom the exact path would use
  carries a decoded synopsis, the tile is synthesized from it and the
  response carries ``X-Heatmap-Synopsis: max_err=<n>`` plus a
  ``"syn-``-prefixed ETag (approximate and exact bytes must never
  revalidate against each other). Without a synopsis at that zoom —
  including every ``z >= synopsis_max_z`` request — the exact path
  answers byte-identically to an un-annotated request.
- ``GET /query?layer=&bbox=&z=&op=sum|topk|quantile&k=&q=`` — O(1)
  range analytics over the integral pyramids (docs/analytics.md):
  ``bbox`` is an inclusive cell rect ``x0,y0,x1,y1`` at source grid
  zoom ``z``. Served from the level's summed-area table when the store
  carries one, falling through to an exact row scan (slower, same
  answer) when it predates integral artifacts; brownout rung >= 1
  answers ``op=sum`` from the synopsis-reconstructed grid with the
  achieved L-inf error bound in ``X-Heatmap-Query-Error``. Malformed
  parameters get typed 400s; ETags live in a ``"q-``-prefixed
  namespace and results ride the same byte-capped LRU with
  stale-if-error semantics as tiles.
- ``GET /series?name=&label=&from=&to=&step=`` — aligned history
  frames from the embedded telemetry tiers (obs/timeseries.py) with
  the achieved resolution stamped per frame; a well-formed
  ``enabled: false`` answer when the sampler is off
- ``GET /dashboard``                      — self-contained operational
  page (serve/dashboard.py): inline HTML/SVG sparklines over
  ``/series`` + ``/healthz``, zero external assets
- ``GET /healthz``                        — store/cache stats (JSON)
- ``GET /metrics``                        — Prometheus 0.0.4 text from
  the process-wide obs registry (so serving metrics sit next to any
  pipeline metrics the same process produced)
- ``POST /reload``                        — re-read the store artifact;
  the bumped generation lazily invalidates every cached tile

**Graceful degradation** (docs/robustness.md): tile renders run under
the ``tile.render`` fault site and an optional per-render timeout; a
failed render serves the last-good cached bytes (stale-200, cache
``"stale"`` in the ``http_request`` event) when the TileCache has them
and a typed 503 JSON body otherwise — never a 500. A failed
``/reload`` keeps the last-good index (TileStore builds the new index
before swapping) and returns 503. Both paths flip the app into a
degraded state with a named cause, edge-triggered as
``degraded_enter``/``degraded_exit`` obs events, and ``/healthz``
reports ``"status": "degraded"`` with the live causes until the next
successful render/reload clears them.

Tiles carry **strong ETags** (crc32 of the payload — cheap, and tile
payloads are small enough that collision risk is irrelevant for cache
revalidation); a matching ``If-None-Match`` short-circuits to 304 with
no body. The ETag comes from the cached bytes, so revalidation is a
cache hit, not a re-render.

One ServeApp is shared by every handler thread: TileStore swaps are
atomic, TileCache is internally locked, and the obs registry is
thread-safe — the handler itself holds no mutable state. Request
logging goes to the obs event log (``http_request`` events), never
stdout: ``log_message`` is overridden so the server prints nothing.
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import threading
import time
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.analytics import metrics as analytics_metrics
from heatmap_tpu_torch.analytics import query as analytics_query
from heatmap_tpu_torch.obs import (anomaly, incident, recorder, slo, timeseries,
                             tracing)
from heatmap_tpu_torch.serve import dashboard as dashboard_mod
from heatmap_tpu_torch.serve import degrade as degrade_mod
from heatmap_tpu_torch.serve.cache import TileCache
from heatmap_tpu_torch.serve.render import (SynopsisLayer, synopsis_source,
                                      tile_json_bytes, tile_png_bytes)
from heatmap_tpu_torch.serve.store import TileStore

_registry = obs.get_registry()
HTTP_REQUESTS = _registry.counter(
    "http_requests_total", "HTTP requests served",
    labelnames=("route", "status"))

_TILE_RE = re.compile(
    r"^/tiles/(?P<layer>[^/]+)/(?P<z>\d{1,2})/(?P<x>\d+)/(?P<y>\d+)"
    r"\.(?P<fmt>png|json)$")

_CONTENT_TYPES = {"png": "image/png", "json": "application/json"}


def _etag(body: bytes) -> str:
    return f'"{zlib.crc32(body):08x}"'


def _syn_etag(body: bytes) -> str:
    # Distinct namespace from exact ETags: a client holding exact bytes
    # must re-fetch when it asks for a synopsis (and vice versa), even
    # on the astronomically-unlikely crc collision.
    return f'"syn-{zlib.crc32(body):08x}"'


def _query_etag(body: bytes) -> str:
    # Query results get their own namespace too: a /query body must
    # never revalidate against a tile's (or a synopsis tile's) ETag.
    return f'"q-{zlib.crc32(body):08x}"'


def _temporal_etag(body: bytes) -> str:
    # Temporal folds are a fourth namespace: an as_of/window tile must
    # never revalidate against the all-time tile's ETag (same bytes at
    # one instant is a coincidence, not an identity).
    return f'"t-{zlib.crc32(body):08x}"'


def _temporal_opt(query: str) -> dict | None:
    """Raw ``?as_of=/window=/decay=`` values (last-wins), or None when
    the request has no temporal params. The query string still never
    participates in routing, so the fleet router colocates every
    temporal variant of a tile with its all-time twin for free."""
    if not query:
        return None
    params = urllib.parse.parse_qs(query)
    out = {}
    for name in ("as_of", "window", "decay"):
        vals = params.get(name)
        if vals:
            out[name] = vals[-1]
    return out or None


def local_series_response(query: str):
    """Answer ``GET /series`` from this process's telemetry store —
    the same 6-tuple contract as ``handle()``. Module-level (not a
    ServeApp method) so the fleet router serves its own history
    through the identical parser before merging backend frames."""
    params = urllib.parse.parse_qs(query) if query else {}

    def _param(key, default=None):
        vals = params.get(key)
        return vals[-1] if vals else default

    try:
        name = _param("name")
        if not name:
            raise ValueError("missing required parameter name")
        labels = {}
        for raw in params.get("label", []):
            key, eq, value = raw.partition("=")
            if not eq or not key:
                raise ValueError(
                    f"label must be key=value, got {raw!r}")
            labels[key] = value
        bounds = {}
        for key, attr in (("from", "start"), ("to", "end"),
                          ("step", "step")):
            raw = _param(key)
            if raw is None:
                continue
            try:
                bounds[attr] = float(raw)
            except ValueError:
                raise ValueError(f"{key} must be a number, got {raw!r}")
        if bounds.get("step") is not None and bounds["step"] <= 0:
            raise ValueError(f"step must be > 0, got {bounds['step']}")
    except ValueError as e:
        body = json.dumps({"error": "bad query",
                           "detail": str(e)}).encode()
        return 400, "application/json", body, None, "series", None
    store = timeseries.get_store()
    if store is None:
        body = json.dumps({
            "enabled": False, "name": name, "frames": [],
            "detail": "telemetry sampler off "
                      "(--telemetry-sample-interval 0)",
        }, sort_keys=True).encode()
        return 200, "application/json", body, None, "series", None
    doc = store.query(name, labels=labels or None, **bounds)
    doc["enabled"] = True
    body = json.dumps(doc, sort_keys=True).encode()
    return 200, "application/json", body, None, "series", None


class Response(tuple):
    """``handle()`` result. Unpacks as the historical 6-tuple
    ``(status, content_type, body, etag, route, cache)`` — every
    existing consumer keeps working — while optionally carrying extra
    transport headers (``X-Heatmap-Synopsis``) in ``.headers`` for the
    HTTP shell and the fleet router's relay to forward."""

    headers: dict | None = None

    def __new__(cls, status, ctype, body, etag, route, cache,
                headers=None):
        self = super().__new__(
            cls, (status, ctype, body, etag, route, cache))
        if headers:
            self.headers = headers
        return self


class ServeApp:
    """Transport-free request core: ``handle()`` maps (method, path,
    if_none_match) -> (status, content_type, body, etag). The HTTP
    handler below is a thin shell around it, which is what makes the
    serving logic testable without sockets."""

    def __init__(self, store: TileStore, cache: TileCache | None = None,
                 *, render_timeout_s: float | None = None,
                 max_inflight: int | None = None,
                 retry_after_s: float = 1.0,
                 synopsis_default: bool = False,
                 degrade: "degrade_mod.BrownoutController | None" = None,
                 disk_cache=None, prewarm=None):
        self.store = store
        self.cache = cache if cache is not None else TileCache()
        # Disk tier (tilefs.DiskTileCache | None): consulted by the
        # heap cache's flight leader before rendering, write-through
        # after — single-flight for free. Keys carry (generation,
        # delta_epoch), so epochs invalidate structurally.
        self.disk_cache = disk_cache
        # Pre-warm config (tilefs.PrewarmConfig | None): replayed by
        # prewarm_now() at startup (cli/fleet call it once bound) and
        # after every successful /reload.
        self.prewarm = prewarm
        self._prewarm_last: dict | None = None
        self.render_timeout_s = render_timeout_s
        self.max_inflight = max_inflight
        self.retry_after_s = retry_after_s  # advertised on every 503
        # Layer policy for tile requests with no ?synopsis= parameter;
        # an explicit synopsis=0/1 on the URL always wins.
        self.synopsis_default = synopsis_default
        # Brownout ladder (serve/degrade.py); None = compiled out. At
        # rung 0 every request is byte-identical to degrade=None
        # (pinned in tests/test_degrade.py).
        self.degrade = degrade
        self._extra_layers: dict = {}
        self._degraded_lock = threading.Lock()
        self._degraded: dict[str, str] = {}  # cause -> detail
        self._render_pool = None  # lazy; only built when timeouts are on
        self._inflight_lock = threading.Lock()
        self._inflight = 0
        self._draining = False

    # -- degraded state ----------------------------------------------------

    def degraded_causes(self) -> dict:
        """Live degradation causes (empty == healthy)."""
        with self._degraded_lock:
            return dict(self._degraded)

    def _degrade(self, cause: str, detail: str = ""):
        with self._degraded_lock:
            entering = cause not in self._degraded
            self._degraded[cause] = detail
        if entering:  # edge-triggered: one event per episode, not per request
            obs.emit("degraded_enter", cause=cause,
                     **({"detail": detail} if detail else {}))

    def _recover(self, cause: str):
        with self._degraded_lock:
            was_degraded = self._degraded.pop(cause, None) is not None
        if was_degraded:
            obs.emit("degraded_exit", cause=cause)

    # -- layers ------------------------------------------------------------

    def attach_layer(self, name: str, layer) -> None:
        """Mount a non-store layer (live mode). Attached layers survive
        ``/reload`` — that re-reads the artifact only."""
        self._extra_layers[name] = layer

    def layer(self, name: str):
        found = self._extra_layers.get(name)
        return found if found is not None else self.store.layer(name)

    def layer_names(self) -> list:
        return sorted(set(self.store.layer_names()) | set(self._extra_layers))

    # -- request core ------------------------------------------------------

    def handle(self, method: str, path: str,
               if_none_match: str | None = None):
        """Returns ``(status, content_type, body, etag, route, cache)``;
        ``body`` is b"" for 304s, ``cache`` is "hit"/"miss"/"stale"/None.
        Synopsis tile answers are a :class:`Response` whose ``.headers``
        carries ``X-Heatmap-Synopsis`` (it still unpacks as the 6-tuple).
        Injected ``http.request`` faults surface as typed 503s — the
        chaos soak pins that no injected fault ever becomes a 500."""
        try:
            faults.check("http.request", key=method)
        except faults.InjectedFault as e:
            body = json.dumps({"error": "service unavailable",
                               "detail": str(e)}).encode()
            return 503, "application/json", body, None, "error", None
        ctl = self.degrade
        if ctl is not None:
            # Rate-limited burn re-evaluation; between polls this is one
            # clock read. Rung side effects (cache TTL stretch) apply on
            # the edge so the rung-0 path never touches the cache.
            ctl.poll()
            scale = ctl.ttl_scale()
            if scale != self.cache.ttl_scale:
                self.cache.set_ttl_scale(scale)
        # The query string never participates in routing (so the fleet
        # router's rendezvous key colocates ?synopsis=1 with the exact
        # tile); it only carries per-request options.
        path, _, query = path.partition("?")
        m = _TILE_RE.match(path)
        if method == "GET" and m is not None:
            return self._admitted_tile(m, if_none_match,
                                       self._synopsis_opt(query),
                                       _temporal_opt(query))
        if method == "GET" and path == "/query":
            return self._handle_query(query, if_none_match)
        if method == "GET" and path == "/series":
            return self._handle_series(query)
        if method == "GET" and path == "/dashboard":
            body = dashboard_mod.render_page()
            return (200, "text/html; charset=utf-8", body, None,
                    "dashboard", None)
        if method == "GET" and path == "/healthz":
            body = json.dumps(self._health(), indent=2).encode()
            return 200, "application/json", body, None, "healthz", None
        if method == "GET" and path == "/metrics":
            obs.refresh_process_gauges()
            body = _registry.render_prometheus().encode()
            return (200, "text/plain; version=0.0.4", body, None,
                    "metrics", None)
        if method == "POST" and path == "/reload":
            return self._handle_reload()
        if method == "POST" and path in ("/drain", "/undrain"):
            return self._handle_drain(path == "/drain")
        body = json.dumps({"error": "not found", "path": path}).encode()
        return 404, "application/json", body, None, "other", None

    # -- admission + drain -------------------------------------------------

    def _handle_drain(self, draining: bool):
        """Graceful drain: in-flight requests finish, new tile traffic
        sheds with a typed 503 until ``/undrain``. The fleet router
        drains a backend router-side first (pulls it from the ring),
        then forwards here so directly-addressed clients shed too."""
        self._draining = draining
        if draining:
            self._degrade("drain", "draining: shedding tile traffic")
        else:
            self._recover("drain")
        with self._inflight_lock:
            inflight = self._inflight
        body = json.dumps({"draining": draining,
                           "inflight": inflight}).encode()
        return 200, "application/json", body, None, "drain", None

    def _synopsis_opt(self, query: str) -> bool:
        """Resolve the ``synopsis`` query parameter (last value wins,
        per urllib convention) against the app default."""
        if not query:
            return self.synopsis_default
        vals = urllib.parse.parse_qs(query).get("synopsis")
        if not vals:
            return self.synopsis_default
        return vals[-1] not in ("0", "false", "no")

    def _admitted_tile(self, m, if_none_match, synopsis=False,
                       temporal=None):
        """Tile dispatch behind the drain gate and the in-flight bound.
        Shed responses are typed 503s (never 500) and edge-trigger the
        ``shed`` degradation cause so /healthz names why."""
        if self._draining:
            body = json.dumps({"error": "service unavailable",
                               "cause": "drain"}).encode()
            return 503, "application/json", body, None, "tiles", None
        ctl = self.degrade
        if ctl is not None:
            if ctl.shed((m["layer"], m["z"], m["x"], m["y"], m["fmt"])):
                # Top rung: deterministic fractional shed by tile key
                # (same seeded hash router-side, so the fleet agrees).
                if obs.metrics_enabled():
                    degrade_mod.DEGRADE_SHED.inc()
                self._degrade("brownout",
                              f"rung {ctl.rung}: shedding "
                              f"{ctl.shed_fraction:.0%} of tile keys")
                incident.trigger("shed",
                                 detail=f"brownout rung {ctl.rung}")
                body = json.dumps({"error": "service unavailable",
                                   "cause": "brownout"}).encode()
                return 503, "application/json", body, None, "tiles", None
            if ctl.rung < ctl.max_rung:
                self._recover("brownout")
        limit = (self.max_inflight if ctl is None
                 else ctl.inflight_limit(self.max_inflight))
        if limit is None:
            return self._handle_tile(m, if_none_match, synopsis, temporal)
        with self._inflight_lock:
            if self._inflight >= limit:
                admitted = False
            else:
                admitted = True
                self._inflight += 1
        if not admitted:
            self._degrade("shed",
                          f"in-flight bound {limit} reached")
            # Every typed-503 shed is an incident trigger edge (the
            # manager rate-limits per kind, so a shed burst flushes
            # one bundle, not one per rejected request).
            incident.trigger(
                "shed", detail=f"in-flight bound {limit}")
            body = json.dumps({"error": "service unavailable",
                               "cause": "shed"}).encode()
            return 503, "application/json", body, None, "tiles", None
        try:
            self._recover("shed")
            return self._handle_tile(m, if_none_match, synopsis, temporal)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _handle_reload(self):
        try:
            generation = self.store.reload()
        except Exception as e:
            # TileStore builds the new index before swapping, so the
            # last-good one is still serving; report that honestly.
            self._degrade("reload", repr(e))
            body = json.dumps({
                "error": "reload failed", "detail": repr(e),
                "generation": self.store.generation,
            }).encode()
            return 503, "application/json", body, None, "reload", None
        self._recover("reload")
        # Re-warm after the swap: the new generation/delta_epoch keys
        # are all cold, and the reload already paid the expensive part
        # (index rebuild), so replaying the popular head now converts
        # the first post-reload requests from misses into hits.
        self.prewarm_now(source="reload")
        body = json.dumps({"generation": generation}).encode()
        return 200, "application/json", body, None, "reload", None

    def prewarm_now(self, source: str = "startup"):
        """Replay the configured popularity plan (tilefs.PrewarmConfig)
        through :meth:`handle`, filling the heap + disk caches. No-op
        without a config or recorded traffic; returns the warm summary
        (also kept for ``/healthz``). Callers decide *when*: the cli and
        fleet backends warm once bound, ``_handle_reload`` re-warms, and
        a bare ServeApp never warms implicitly."""
        cfg = self.prewarm
        if cfg is None:
            return None
        from heatmap_tpu_torch.tilefs import prewarm as prewarm_mod

        plan = prewarm_mod.build_plan(cfg.events, top_k=cfg.top_k,
                                      half_life=cfg.half_life)
        if not plan:
            return None
        summary = prewarm_mod.warm(self, plan, budget_s=cfg.budget_s,
                                   budget_bytes=cfg.budget_bytes,
                                   source=source)
        self._prewarm_last = summary
        return summary

    # -- telemetry ---------------------------------------------------------

    def _handle_series(self, query: str):
        """``GET /series?name=&label=k=v&from=&to=&step=``: aligned
        frames from the telemetry tiers (obs/timeseries.py), achieved
        resolution stamped per frame. Sampler off is a well-formed
        answer (``enabled: false``, no frames), not an error — the
        dashboard polls this unconditionally. Deterministic: the same
        explicit ``from``/``to`` window over a quiescent store answers
        byte-identically on every query (pinned in
        tests/test_timeseries.py)."""
        return local_series_response(query)

    # -- range queries -----------------------------------------------------

    def _handle_query(self, query: str, if_none_match):
        """``GET /query``: O(1) range analytics (docs/analytics.md).

        Path selection, most to least exact-and-fast: the level's
        integral pyramid (four SAT corner lookups / pruned descent);
        the exact level rows when the store predates integral
        artifacts (slower, identical answer); the synopsis grid for
        ``op=sum`` under brownout rung >= 1, with the achieved error
        bound (stamped cell bound x rect area) in
        ``X-Heatmap-Query-Error``. Results are cached in the shared
        byte-capped LRU under the store generation (plus the synopsis
        epoch on the brownout path) with tile-style stale-if-error."""
        t0 = time.monotonic()
        params = urllib.parse.parse_qs(query) if query else {}

        def _param(name, default=None):
            vals = params.get(name)
            return vals[-1] if vals else default

        try:
            op = analytics_query.validate_op(_param("op", "sum"))
            if op in analytics_query.TEMPORAL_OPS:
                # Time-axis ops have their own parameter surface
                # (window instead of bbox) and their own evaluator.
                return self._handle_growth_query(params, if_none_match)
            layer_name = urllib.parse.unquote(_param("layer", "default"))
            z_raw = _param("z")
            if z_raw is None:
                raise ValueError(
                    "missing required parameter z (source grid zoom)")
            try:
                z = int(z_raw)
            except ValueError:
                raise ValueError(f"z must be an integer zoom, got {z_raw!r}")
            if not 0 <= z <= 30:
                raise ValueError(f"z must be in [0, 30], got {z}")
            bbox_raw = _param("bbox")
            if bbox_raw is None:
                raise ValueError("missing required parameter bbox "
                                 "('x0,y0,x1,y1' inclusive cells)")
            rect = analytics_query.parse_bbox(bbox_raw, z)
            try:
                k = int(_param("k", "10"))
            except ValueError:
                raise ValueError(f"k must be an integer, got {_param('k')!r}")
            if op == "topk" and k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            try:
                q = float(_param("q", "0.5"))
            except ValueError:
                raise ValueError(f"q must be a float, got {_param('q')!r}")
            if op == "quantile" and not 0.0 <= q <= 1.0:
                raise ValueError(f"q must be in [0, 1], got {q}")
        except ValueError as e:
            body = json.dumps({"error": "bad query",
                               "detail": str(e)}).encode()
            return 400, "application/json", body, None, "query", None
        layer = self.layer(layer_name)
        if layer is None:
            body = json.dumps({"error": "unknown layer",
                               "layers": self.layer_names()}).encode()
            return 404, "application/json", body, None, "query", None
        integrals = getattr(layer, "integrals", None) or {}
        synopses = getattr(layer, "synopses", None) or {}
        ctl = self.degrade
        syn_view = None
        if (ctl is not None and ctl.force_synopsis() and op == "sum"
                and z in synopses):
            # Brownout: answer from the synopsis-reconstructed grid
            # when one exists at this zoom; otherwise stay exact (an
            # exact answer under load beats a missing one).
            syn_view = synopses[z]
        if syn_view is not None:
            mode = "synopsis"
        elif z in integrals:
            mode = "integral"
        elif z in getattr(layer, "levels", {}):
            mode = "fallback"
        else:
            body = json.dumps({
                "error": f"no stored level at zoom {z}",
                "detail_zooms": sorted(getattr(layer, "levels", {})),
            }).encode()
            return 404, "application/json", body, None, "query", None
        r0, c0, r1, c1 = rect
        area = (r1 - r0 + 1) * (c1 - c0 + 1)
        doc = {"op": op, "layer": layer_name, "z": z,
               "bbox": [c0, r0, c1, r1], "path": mode}
        if op == "topk":
            doc["k"] = k
        elif op == "quantile":
            doc["q"] = q
        extra = None
        if mode == "synopsis":
            # Per-cell bound from the artifact stamp; a rect sum over
            # ``area`` cells can be off by at most ``max_err * area``.
            bound = float(syn_view.max_err) * area
            extra = {"X-Heatmap-Query-Error": f"max_err={bound:.6g}"}
            doc["max_err"] = bound
            key = ("query", layer_name, z, rect, op, "syn",
                   self.store.synopsis_epoch)
        else:
            key = ("query", layer_name, z, rect, op,
                   k if op == "topk" else None,
                   q if op == "quantile" else None)

        def _evaluate() -> bytes:
            out = dict(doc)
            if mode == "integral":
                pair = integrals[z]
                out["cells"] = pair.cell_count(*rect)
                if op == "sum":
                    out["sum"] = analytics_query.range_sum(pair, rect)
                elif op == "topk":
                    out["hotspots"] = [
                        [int(c), int(r), v] for r, c, v in
                        analytics_query.top_k_hotspots(pair, rect, k)]
                else:
                    out["value"] = analytics_query.quantile(pair, rect, q)
            else:
                level = (syn_view.level if mode == "synopsis"
                         else layer.levels[z])
                rows, cols, vals = analytics_query.level_cells(level, rect)
                out["cells"] = int(len(vals))
                if op == "sum":
                    out["sum"] = float(vals.sum()) if len(vals) else 0.0
                elif op == "topk":
                    out["hotspots"] = [
                        [int(c), int(r), v] for r, c, v in
                        analytics_query.top_k_rows(level, rect, k)]
                else:
                    out["value"] = analytics_query.quantile_rows(
                        level, rect, q)
            return json.dumps(out).encode()

        try:
            body, hit = self.cache.get_or_render(
                key, self.store.generation, _evaluate, fmt="query",
                stale_if_error=True)
        except Exception as e:
            self._degrade("render", repr(e))
            payload = json.dumps({"error": "query failed",
                                  "detail": repr(e)}).encode()
            return 503, "application/json", payload, None, "query", None
        if hit == TileCache.STALE:
            self._degrade("render", "serving stale query results")
            cache = "stale"
        else:
            if hit is False:
                self._recover("render")
            cache = "hit" if hit else "miss"
        ms = round((time.monotonic() - t0) * 1e3, 3)
        if obs.metrics_enabled():
            analytics_metrics.QUERY_SECONDS.observe(
                time.monotonic() - t0, op=op)
        cells = json.loads(body).get("cells")
        obs.emit("query_served", op=op, zoom=int(z), path=mode,
                 layer=layer_name, bbox_area=int(area), ms=ms,
                 **({"cells": int(cells)} if cells is not None else {}),
                 **({"k": k} if op == "topk" else {}),
                 **({"q": q} if op == "quantile" else {}),
                 **({"max_err": doc["max_err"]}
                    if mode == "synopsis" else {}))
        etag = _query_etag(body)
        if if_none_match is not None and etag in if_none_match:
            return Response(304, "application/json", b"", etag, "query",
                            cache, headers=extra)
        return Response(200, "application/json", body, etag, "query",
                        cache, headers=extra)

    def _handle_growth_query(self, params, if_none_match):
        """``GET /query?op=topk_growth&window=1w``: top-k cells by
        growth over the trailing window, from Haar wavelet histograms
        over the per-bucket cell series (temporal/timequery.py). The
        answer is approximate with a SOUND stamped bound: the achieved
        error rides ``X-Heatmap-Query-Error`` exactly like the synopsis
        /query path, and the oracle test pins ``|approx - exact| <=
        bound`` cell by cell. Cached under the fold selection token, so
        results survive until the underlying buckets actually change."""
        from heatmap_tpu_torch.temporal import buckets as tb
        from heatmap_tpu_torch.temporal import fold as tfold
        from heatmap_tpu_torch.temporal import timequery
        from heatmap_tpu_torch.temporal.metrics import TEMPORAL_REQUESTS

        t0 = time.monotonic()

        def _param(name, default=None):
            vals = params.get(name)
            return vals[-1] if vals else default

        try:
            layer_name = urllib.parse.unquote(_param("layer", "default"))
            z_raw = _param("z")
            if z_raw is None:
                raise ValueError(
                    "missing required parameter z (source grid zoom)")
            try:
                z = int(z_raw)
            except ValueError:
                raise ValueError(f"z must be an integer zoom, got {z_raw!r}")
            window_raw = _param("window")
            if window_raw is None:
                raise ValueError("op=topk_growth requires window= "
                                 "(1h|1d|1w or seconds)")
            try:
                k = int(_param("k", "10"))
            except ValueError:
                raise ValueError(f"k must be an integer, got {_param('k')!r}")
            if k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            try:
                coeffs = int(_param("m", str(timequery.DEFAULT_COEFFS)))
            except ValueError:
                raise ValueError(
                    f"m must be an integer coefficient budget, "
                    f"got {_param('m')!r}")
            if coeffs < 1:
                raise ValueError(f"m must be >= 1, got {coeffs}")
            root = self.store.temporal_root()
            if root is None:
                raise ValueError(
                    "op=topk_growth needs a delta-shaped store "
                    f"(store spec is {self.store.spec!r})")
            cfg = tfold.temporal_config(root)
            if cfg is None:
                raise ValueError(
                    "store has no temporal config — run a bucketed "
                    "compaction (docs/temporal.md) first")
            window = tb.parse_window(window_raw, cfg)
        except ValueError as e:
            body = json.dumps({"error": "bad query",
                               "detail": str(e)}).encode()
            return 400, "application/json", body, None, "query", None
        layer = self.layer(layer_name)
        if layer is None:
            body = json.dumps({"error": "unknown layer",
                               "layers": self.layer_names()}).encode()
            return 404, "application/json", body, None, "query", None
        # select_fold is metadata-only and deterministic, so this token
        # is the same one the evaluator will compute — a valid pre-
        # render cache key that retires exactly when buckets change.
        sel = tfold.select_fold(root, window=window)
        key = ("query", layer_name, z, "growth", window_raw, k, coeffs,
               sel.token)

        def _evaluate() -> bytes:
            doc = timequery.topk_growth(
                root, user=layer.user, timespan=layer.timespan,
                zoom=z, window=window, k=k, coeffs=coeffs)
            doc["layer"] = layer_name
            return json.dumps(doc).encode()

        try:
            body, hit = self.cache.get_or_render(
                key, self.store.generation, _evaluate, fmt="query",
                stale_if_error=True)
        except Exception as e:
            self._degrade("render", repr(e))
            payload = json.dumps({"error": "query failed",
                                  "detail": repr(e)}).encode()
            return 503, "application/json", payload, None, "query", None
        if hit == TileCache.STALE:
            self._degrade("render", "serving stale query results")
            cache = "stale"
        else:
            if hit is False:
                self._recover("render")
            cache = "hit" if hit else "miss"
        doc = json.loads(body)
        ms = round((time.monotonic() - t0) * 1e3, 3)
        if obs.metrics_enabled():
            analytics_metrics.QUERY_SECONDS.observe(
                time.monotonic() - t0, op="topk_growth")
            TEMPORAL_REQUESTS.inc(mode="growth")
        obs.emit("query_served", op="topk_growth", zoom=int(z),
                 path="temporal", layer=layer_name, k=k, ms=ms,
                 window=window_raw, slots=int(doc.get("slots", 0)),
                 max_err=float(doc.get("max_err", 0.0)),
                 cells=len(doc.get("cells", [])))
        extra = {"X-Heatmap-Query-Error":
                 f"max_err={doc.get('max_err', 0.0):.6g}"}
        etag = _query_etag(body)
        if if_none_match is not None and etag in if_none_match:
            return Response(304, "application/json", b"", etag, "query",
                            cache, headers=extra)
        return Response(200, "application/json", body, etag, "query",
                        cache, headers=extra)

    def _handle_temporal_tile(self, m, if_none_match, temporal):
        """``?as_of=/window=/decay=`` tiles: render from a partial-
        pyramid fold (heatmap_tpu_torch.temporal) instead of the all-time
        index. Cache keys carry the bucket cut: undecayed window tiles
        use the STABLE key ``(..., "w", param)`` so delta refreshes and
        bucket rolls can invalidate exactly the dirtied entries, while
        as_of/decay tiles fold the selection token into the key —
        history below a cut is immutable, so those entries survive
        unrelated ingest structurally. A torn bucket surfaces inside
        the render and the stale-if-error cache serves last-good bytes;
        the all-time path never reads buckets and is unaffected."""
        from heatmap_tpu_torch.temporal import buckets as tb
        from heatmap_tpu_torch.temporal import fold as tfold
        from heatmap_tpu_torch.temporal.metrics import TEMPORAL_REQUESTS

        t0 = time.monotonic()
        layer_name = urllib.parse.unquote(m["layer"])
        z, x, y = int(m["z"]), int(m["x"]), int(m["y"])
        fmt = m["fmt"]
        if not (0 <= x < (1 << z) and 0 <= y < (1 << z)):
            body = json.dumps({"error": "off-grid tile",
                               "layers": self.layer_names()}).encode()
            return 404, "application/json", body, None, "tiles", None
        root = self.store.temporal_root()
        try:
            if root is None:
                raise ValueError(
                    "temporal params need a delta-shaped store "
                    f"(store spec is {self.store.spec!r})")
            cfg = tfold.temporal_config(root)
            if cfg is None:
                raise ValueError(
                    "store has no temporal config — run a bucketed "
                    "compaction (docs/temporal.md) before temporal "
                    "queries")
            as_of = (float(temporal["as_of"])
                     if "as_of" in temporal else None)
            window = (tb.parse_window(temporal["window"], cfg)
                      if "window" in temporal else None)
            decay = (tb.parse_window(temporal["decay"], cfg)
                     if "decay" in temporal else None)
        except (ValueError, TypeError) as e:
            body = json.dumps({"error": "bad temporal query",
                               "detail": str(e)}).encode()
            return 400, "application/json", body, None, "tiles", None
        mode = ("as_of" if as_of is not None
                else "decay" if decay is not None else "window")
        if mode == "window" and decay is None and as_of is None:
            key = (layer_name, z, x, y, fmt, "w", temporal["window"])
            self.cache.note_window_param(temporal["window"])
        else:
            # select_fold reads only CURRENT + manifest + journal meta
            # (never bucket bytes), so keying cannot trip on a torn
            # bucket — that surfaces inside the render below, where
            # stale-if-error can absorb it.
            sel = tfold.select_fold(root, as_of=as_of, window=window,
                                    decay=decay)
            key = (layer_name, z, x, y, fmt, "t", sel.token)
        render = tile_png_bytes if fmt == "png" else tile_json_bytes

        def render_fn():
            layers, _token = self.store.temporal_view(
                as_of=as_of, window=window, decay=decay)
            layer = layers.get(layer_name)
            if layer is None:
                return None  # no data for this layer inside the cut
            return self._render(render, layer, z, x, y, fmt)

        try:
            body, hit = self.cache.get_or_render(
                key, self.store.generation, render_fn,
                fmt=fmt, stale_if_error=True)
        except Exception as e:
            self._degrade("render", repr(e))
            payload = json.dumps({"error": "render failed",
                                  "detail": repr(e)}).encode()
            return 503, "application/json", payload, None, "tiles", None
        if hit == TileCache.STALE:
            self._degrade("render", "serving stale tiles")
            cache = "stale"
        else:
            if hit is False:
                self._recover("render")
            cache = "hit" if hit else "miss"
        if body is None:
            payload = json.dumps({"error": "empty tile"}).encode()
            return 404, "application/json", payload, None, "tiles", cache
        if obs.metrics_enabled():
            TEMPORAL_REQUESTS.inc(mode=mode)
        obs.emit("temporal_served", layer=layer_name, zoom=int(z),
                 mode=mode, cache=cache,
                 ms=round((time.monotonic() - t0) * 1e3, 3),
                 **{k: temporal[k] for k in ("as_of", "window", "decay")
                    if k in temporal})
        extra = {"X-Heatmap-Temporal": mode}
        etag = _temporal_etag(body)
        if if_none_match is not None and etag in if_none_match:
            return Response(304, _CONTENT_TYPES[fmt], b"", etag, "tiles",
                            cache, headers=extra)
        return Response(200, _CONTENT_TYPES[fmt], body, etag, "tiles",
                        cache, headers=extra)

    def _handle_tile(self, m, if_none_match, synopsis=False,
                     temporal=None):
        if temporal is not None:
            return self._handle_temporal_tile(m, if_none_match, temporal)
        # Layer names may carry characters clients percent-encode in a
        # path segment (the delta stores' "user|timespan" keys).
        layer_name = urllib.parse.unquote(m["layer"])
        z, x, y = int(m["z"]), int(m["x"]), int(m["y"])
        fmt = m["fmt"]
        layer = self.layer(layer_name)
        if layer is None or not (0 <= x < (1 << z) and 0 <= y < (1 << z)):
            body = json.dumps({
                "error": "unknown layer" if layer is None else "off-grid tile",
                "layers": self.layer_names(),
            }).encode()
            return 404, "application/json", body, None, "tiles", None
        # ?synopsis=1 only takes effect when the SAME source zoom the
        # exact path would use carries a decoded synopsis; otherwise
        # fall through to the exact path under the exact cache key and
        # ETag — byte-identical to an un-annotated request. The brownout
        # ladder overrides the opt-in: rung >= 1 forces the synopsis
        # path, rung >= 2 additionally stretches it (a coarser
        # synopsis-carrying source upsamples into zooms that have no
        # natural synopsis — the raised zoom ceiling).
        ctl = self.degrade
        stretch = False
        if ctl is not None:
            synopsis = synopsis or ctl.force_synopsis()
            stretch = ctl.stretch_synopsis()
        syn_view = syn_src = None
        stretched = False
        if synopsis:
            src, view = synopsis_source(layer, z)
            if view is None and stretch:
                src, view = synopsis_source(layer, z, stretch=True)
                stretched = view is not None
            if view is not None:
                syn_view, syn_src = view, src
                layer = SynopsisLayer(
                    layer, max_level=src if stretched else None)
        if syn_view is None:
            key = (layer_name, z, x, y, fmt)
        else:
            # The synopsis_epoch in the key retires approximate bytes
            # whenever the decoded views change (reload, refresh, a
            # provisional early-serve publish) — the generation alone
            # does not move on a provisional overlay.
            key = (layer_name, z, x, y, fmt, "syn",
                   self.store.synopsis_epoch)
        render = tile_png_bytes if fmt == "png" else tile_json_bytes
        render_fn = lambda: self._render(render, layer, z, x, y, fmt)  # noqa: E731
        if self.disk_cache is not None:
            # Disk tier between the heap LRU and the renderer. The heap
            # cache's single-flight leader runs this fill, so at most
            # one thread touches disk per key. The key folds in the
            # store's invalidation epochs: generation retires bytes on
            # reload/compaction, delta_epoch on every journal apply
            # (synopsis keys already carry synopsis_epoch in `key`).
            # A torn or missing entry reads as a miss; a failed
            # write-through is a skipped optimization, never an error.
            dkey = (key, self.store.generation, self.store.delta_epoch)
            inner = render_fn

            def render_fn():
                cached = self.disk_cache.get(dkey)
                if cached is not None:
                    return cached
                body = inner()
                if body is not None:
                    self.disk_cache.put(dkey, body)
                return body
        try:
            body, hit = self.cache.get_or_render(
                key, self.store.generation, render_fn,
                fmt=fmt, stale_if_error=True)
        except Exception as e:
            # No last-good bytes to fall back on: typed 503, never 500.
            self._degrade("render", repr(e))
            payload = json.dumps({"error": "render failed",
                                  "detail": repr(e)}).encode()
            return 503, "application/json", payload, None, "tiles", None
        if hit == TileCache.STALE:
            self._degrade("render", "serving stale tiles")
            cache = "stale"
        else:
            if hit is False:  # a fresh render succeeded end-to-end
                self._recover("render")
            cache = "hit" if hit else "miss"
        if body is None:
            payload = json.dumps({"error": "empty tile"}).encode()
            return 404, "application/json", payload, None, "tiles", cache
        extra = None
        if syn_view is not None:
            marker = f"max_err={syn_view.max_err:.6g}"
            if syn_view.stale:
                marker += "; stale=1"
            if stretched:
                # Raised-ceiling answers add quadrant-upsample error on
                # top of the stamped coefficient error; say so.
                marker += "; stretch=1"
            extra = {"X-Heatmap-Synopsis": marker}
            obs.emit("synopsis_served", layer=layer_name, zoom=int(z),
                     max_err=float(syn_view.max_err),
                     source_zoom=int(syn_src),
                     **({"stale": True} if syn_view.stale else {}),
                     **({"stretched": True} if stretched else {}))
            etag = _syn_etag(body)
        else:
            etag = _etag(body)
        if if_none_match is not None and etag in if_none_match:
            return Response(304, _CONTENT_TYPES[fmt], b"", etag, "tiles",
                            cache, headers=extra)
        return Response(200, _CONTENT_TYPES[fmt], body, etag, "tiles",
                        cache, headers=extra)

    def _render(self, render, layer, z, x, y, fmt: str):
        """One tile render under the ``tile.render`` fault site and the
        optional per-render deadline. The deadline runs the render on a
        worker thread so a wedged renderer costs the request a bounded
        wait, not the whole server a thread forever; the abandoned
        render finishes (or dies) in the pool without a waiter."""
        faults.check("tile.render", key=fmt)
        if self.render_timeout_s is None:
            return render(layer, z, x, y)
        if self._render_pool is None:
            with self._degraded_lock:
                if self._render_pool is None:
                    self._render_pool = (
                        concurrent.futures.ThreadPoolExecutor(
                            max_workers=4,
                            thread_name_prefix="tile-render"))
        # context_bound carries the ambient request span into the pool
        # worker (a plain submit would start from an empty context and
        # the worker-side span would orphan into its own trace).
        def pooled(layer, z, x, y):
            span = tracing.begin_span("tile.render.worker", {"format": fmt})
            try:
                return render(layer, z, x, y)
            finally:
                tracing.end_span(span)

        future = self._render_pool.submit(
            tracing.context_bound(pooled), layer, z, x, y)
        try:
            return future.result(timeout=self.render_timeout_s)
        except concurrent.futures.TimeoutError:
            future.cancel()
            raise TimeoutError(
                f"tile render exceeded {self.render_timeout_s}s deadline")

    def _health(self) -> dict:
        stats = self.store.stats()
        for name, layer in sorted(self._extra_layers.items()):
            stats["layers"][name] = {
                "user": layer.user,
                "timespan": layer.timespan,
                "detail_zooms": layer.detail_zooms,
                "result_delta": layer.result_delta,
                "rows": int(sum(len(l) for l in layer.levels.values())),
                "live": True,
            }
        stats["cache"] = {"entries": len(self.cache),
                          "bytes": self.cache.nbytes}
        if self.disk_cache is not None:
            stats["disk_cache"] = self.disk_cache.stats()
        if self._prewarm_last is not None:
            stats["prewarm"] = self._prewarm_last
        with self._inflight_lock:
            stats["inflight"] = self._inflight
        stats["draining"] = self._draining
        causes = self.degraded_causes()
        stats["status"] = "degraded" if causes else "ok"
        if causes:
            stats["degraded"] = causes
        slo_state = slo.slo_status()
        if slo_state is not None:
            stats["slo"] = slo_state
        # Numeric distance-to-breach, not just breach: per-objective
        # burn fractions ({} folded away when no engine is installed)
        # plus the brownout ladder state the router probes read.
        burns = slo.burn_values()
        if burns:
            stats["slo_burn"] = {k: round(float(v), 4)
                                 for k, v in sorted(burns.items())}
        if self.degrade is not None:
            stats["degrade"] = self.degrade.snapshot()
        # Telemetry store + anomaly engine state (when armed): the
        # dashboard's status chips and anomaly panel read these.
        ts_store = timeseries.get_store()
        if ts_store is not None:
            stats["telemetry"] = ts_store.stats()
        engine = anomaly.get_engine()
        if engine is not None:
            stats["anomalies"] = engine.recent(16)
            stats["anomaly_watches"] = engine.status()["watches"]
        return stats


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Keep-alive + small responses otherwise hit the Nagle/delayed-ACK
    # interaction: every cached tile pays a ~40ms ACK stall.
    disable_nagle_algorithm = True
    app: ServeApp  # bound by make_server

    def _dispatch(self, method: str):
        t0 = time.monotonic()
        # Each request is a trace root (sampled per --trace-sample); an
        # incoming traceparent header instead continues the client's
        # trace, inheriting its sampled flag. Handler threads start
        # with a fresh context, so every request tree is independent.
        req_span = tracing.begin_span(
            "serve.request", {"method": method, "path": self.path},
            traceparent=self.headers.get("traceparent"))
        try:
            try:
                result = self.app.handle(
                    method, self.path, self.headers.get("If-None-Match"))
                status, ctype, body, etag, route, cache = result
                extra_headers = getattr(result, "headers", None)
            except Exception as e:  # defensive: a render bug must not kill serving
                status, ctype, route, cache = (500, "application/json",
                                               "error", None)
                body = json.dumps({"error": repr(e)}).encode()
                etag = None
                extra_headers = None
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if extra_headers:
                for name, value in extra_headers.items():
                    self.send_header(name, value)
            if status == 503:
                # Shed/drain/degraded answers are retryable by
                # construction; tell well-behaved clients when. The
                # advertised delay carries seeded jitter (the
                # faults/retry.py shape) so a burst of shed clients
                # does not come back as a synchronized thundering herd.
                retry_after = getattr(self.app, "retry_after_s", 1.0)
                self.send_header(
                    "Retry-After",
                    str(degrade_mod.retry_after_jitter(
                        retry_after, self.path, int(t0))))
            if etag is not None:
                self.send_header("ETag", etag)
            tp = tracing.current_traceparent()
            if tp is not None:
                self.send_header("traceparent", tp)
            self.end_headers()
            if body:
                self.wfile.write(body)
            if obs.metrics_enabled():
                HTTP_REQUESTS.inc(route=route, status=str(status))
            ms = round((time.monotonic() - t0) * 1e3, 3)
            # Emitted while the request span is still ambient, so the
            # event is stamped with this tree's trace_id/span_id.
            obs.emit("http_request", route=route, status=int(status),
                     path=self.path, ms=ms, bytes=len(body),
                     **({"cache": cache} if cache else {}))
            # Tail-based retention: a 5xx or a tail-latency outlier
            # promotes this request's tree out of the flight-recorder
            # ring even when head sampling dropped it. Must run before
            # end_span so the root itself rides the live-forward path.
            recorder.maybe_promote(req_span, status=status, ms=ms)
        finally:
            tracing.end_span(req_span)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # request logging goes through obs events, never stdout


def make_server(app: ServeApp, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bound-but-not-serving ThreadingHTTPServer (port 0 = ephemeral;
    read the real one from ``server.server_address[1]``). Caller runs
    ``serve_forever()`` — inline (CLI) or in a thread (tests/bench)."""
    handler = type("Handler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def serve_in_thread(app: ServeApp, host: str = "127.0.0.1", port: int = 0):
    """Test/bench helper: returns ``(server, base_url)`` with
    serve_forever running on a daemon thread; ``server.shutdown()``
    stops it."""
    server = make_server(app, host, port)
    thread = threading.Thread(target=server.serve_forever,
                              name="serve-http", daemon=True)
    thread.start()
    h, p = server.server_address[:2]
    return server, f"http://{h}:{p}"
