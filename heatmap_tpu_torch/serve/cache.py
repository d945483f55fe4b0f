"""TileCache: thread-safe LRU (byte cap) + TTL + single-flight renders.

The port's copy of heatmap_tpu/serve/cache.py, plus
:meth:`TileCache.invalidate_matching`, which drops the entries a key
set holds by walking the cache (bounded by its byte cap) instead of
iterating the set (a delta's ``TileKeySet``).

Serving semantics drive the three mechanisms:

- **LRU by bytes, not entries** — tile payloads span two orders of
  magnitude (a 4-cell JSON doc vs a dense 256px PNG), so an entry-count
  cap would let a few hot dense tiles evict thousands of cheap ones.
- **TTL** — a decayed live layer (serve/live.py) and operators pointing
  the store at a directory another job is rewriting both need staleness
  bounded by wall-clock, not only by explicit invalidation.
- **Single-flight** — N concurrent misses on one cold tile must render
  ONCE: the first requester becomes the flight leader, the rest block
  on its event and share the result (or its exception). Without this, a
  popular tile going cold stampedes the renderer with N identical
  renders — the classic cache-stampede failure under map-client load.

Invalidation is generation-based: every entry is stamped with the
store generation it was rendered from; ``store.reload()`` bumps the
generation and stale entries die lazily on next touch (no O(cache)
sweep on the serving path). Live-stream ticks instead call
``invalidate_keys`` with just the affected tile keys.

Instrumented on the existing obs registry:
``tile_cache_{hits,misses,evictions}_total``,
``tile_cache_stale_serves_total`` and the ``tile_render_seconds``
histogram (observed around the leader's render only — follower waits
are not renders).

**Stale-if-error** (``get_or_render(..., stale_if_error=True)``): a
generation- or TTL-stale entry is kept as a fallback instead of being
dropped before the re-render. If the render fails, the caller gets the
last-good bytes back with ``hit == TileCache.STALE`` (a truthy string
sentinel, so ``hit is True / hit is False`` checks on the normal paths
are unaffected) and the entry stays cached for the next request; a
successful render replaces it as usual. This is what lets the serve
tier degrade to stale-200 instead of 500 when the store or renderer is
having a bad day (docs/robustness.md).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from heatmap_tpu_torch import obs
from heatmap_tpu_torch.obs import tracing

_registry = obs.get_registry()
CACHE_HITS = _registry.counter(
    "tile_cache_hits_total", "Tile requests served from the cache")
CACHE_MISSES = _registry.counter(
    "tile_cache_misses_total", "Tile requests that required a render")
CACHE_EVICTIONS = _registry.counter(
    "tile_cache_evictions_total", "Cache entries dropped",
    labelnames=("reason",))
CACHE_STALE_SERVES = _registry.counter(
    "tile_cache_stale_serves_total",
    "Stale entries served because the replacing render failed")
RENDER_SECONDS = _registry.histogram(
    "tile_render_seconds", "Wall-clock of on-demand tile renders",
    labelnames=("format",),
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))


class _Entry:
    __slots__ = ("value", "nbytes", "generation", "expires")

    def __init__(self, value, nbytes, generation, expires):
        self.value = value
        self.nbytes = nbytes
        self.generation = generation
        self.expires = expires


class _Flight:
    """One in-progress render; followers wait on ``done``."""

    __slots__ = ("done", "value", "error", "doomed")

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error = None
        # Set by invalidate_matching: the render may have read the index
        # from before the caller's swap, so its bytes are not cached.
        self.doomed = False


#: "No stale fallback available" marker (distinct from a cached None).
_NO_FALLBACK = object()


class TileCache:
    """Keys are opaque hashables (the server uses
    ``(layer, z, x, y, fmt)``); values are bytes-like (sized via
    ``len``). ``max_bytes <= 0`` disables caching but keeps
    single-flight dedup — concurrent identical renders still coalesce.
    """

    #: ``hit`` value for a stale entry served under ``stale_if_error``
    #: after the replacing render failed. Truthy, but never ``is True``.
    STALE = "stale"

    def __init__(self, max_bytes: int = 256 << 20,
                 ttl_s: float | None = None, clock=time.monotonic):
        self.max_bytes = int(max_bytes)
        self.ttl_s = ttl_s if (ttl_s is None or ttl_s > 0) else None
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()
        self._flights: dict = {}
        self._bytes = 0
        self._ttl_scale = 1.0
        # Sliding-window params this cache has served (heatmap_tpu_torch.
        # temporal): targeted invalidation needs to enumerate the
        # window-variant keys of an affected tile, and only the cache
        # knows which ``?window=`` values are actually in play.
        self._window_params: set = set()

    # -- temporal window registry ------------------------------------------

    def note_window_param(self, param: str):
        """Record a served ``?window=`` param so delta refreshes and
        bucket rolls can invalidate its key variants."""
        with self._lock:
            self._window_params.add(str(param))

    def window_params(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._window_params))

    # -- introspection -----------------------------------------------------

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self):
        return len(self._entries)

    @property
    def ttl_scale(self) -> float:
        return self._ttl_scale

    def set_ttl_scale(self, scale: float) -> None:
        """Stretch (or restore) the effective TTL without touching the
        stamped ``expires`` of existing entries: the brownout ladder's
        serve-stale widening. Scale 1.0 is byte-for-byte the original
        behavior; >1.0 lets entries live ``scale * ttl_s`` from insert.
        Generation-based invalidation is unaffected — a reload still
        retires every entry."""
        if scale < 1.0:
            raise ValueError("ttl scale must be >= 1.0")
        with self._lock:
            self._ttl_scale = float(scale)

    def _effective_expiry(self, entry):
        # Caller holds the lock. entry.expires is insert + ttl_s; the
        # scale widens it by (scale - 1) * ttl_s more.
        expires = entry.expires
        if (expires is not None and self._ttl_scale != 1.0
                and self.ttl_s is not None):
            expires += (self._ttl_scale - 1.0) * self.ttl_s
        return expires

    # -- core --------------------------------------------------------------

    def get_or_render(self, key, generation: int, render_fn, *,
                      fmt: str = "tile", stale_if_error: bool = False):
        """Cached value for ``key`` at ``generation``, rendering at most
        once across concurrent callers. ``render_fn()`` runs OUTSIDE the
        cache lock. Returns ``(value, hit)``; render errors propagate to
        every waiter of that flight (and are not cached).

        With ``stale_if_error=True`` a generation/TTL-stale entry is
        retained as a fallback: if the replacing render raises, the
        stale bytes are returned with ``hit == TileCache.STALE`` (and
        published to the flight's followers) instead of the error."""
        while True:
            fallback = _NO_FALLBACK
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    expires = self._effective_expiry(entry)
                    if entry.generation != generation or (
                            expires is not None
                            and self._clock() >= expires):
                        if stale_if_error:
                            # Keep the entry: a successful render
                            # replaces it via _insert; a failed one
                            # serves it as the last-good fallback.
                            fallback = entry.value
                        else:
                            reason = ("stale"
                                      if entry.generation != generation
                                      else "ttl")
                            self._drop(key, entry, reason)
                    else:
                        self._entries.move_to_end(key)
                        if obs.metrics_enabled():
                            CACHE_HITS.inc()
                        return entry.value, True
                flight = self._flights.get(key)
                if flight is None:
                    flight = self._flights[key] = _Flight()
                    leader = True
                else:
                    leader = False
            if not leader:
                flight.done.wait()
                if flight.error is not None:
                    raise flight.error
                if obs.metrics_enabled():
                    CACHE_HITS.inc()
                return flight.value, True
            # Flight leader: render outside the lock, publish, insert.
            if obs.metrics_enabled():
                CACHE_MISSES.inc()
            t0 = self._clock()
            # Only the leader's render is a span (followers wait, they
            # don't render) — it parents under the request span of the
            # thread that won the flight.
            tsp = tracing.begin_span("tile.render", {"format": fmt})
            try:
                value = render_fn()
            except BaseException as e:
                tracing.end_span(tsp)
                tsp = None
                if stale_if_error and fallback is not _NO_FALLBACK:
                    if obs.metrics_enabled():
                        CACHE_STALE_SERVES.inc()
                    flight.value = fallback
                    with self._lock:
                        self._flights.pop(key, None)
                    flight.done.set()
                    return fallback, self.STALE
                flight.error = e
                with self._lock:
                    self._flights.pop(key, None)
                flight.done.set()
                raise
            tracing.end_span(tsp)
            if obs.metrics_enabled():
                RENDER_SECONDS.observe(self._clock() - t0, format=fmt)
            flight.value = value
            with self._lock:
                self._flights.pop(key, None)
                if (value is not None and self.max_bytes > 0
                        and not flight.doomed):
                    self._insert(key, value, generation)
            flight.done.set()
            return value, False

    def _insert(self, key, value, generation):
        nbytes = len(value)
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
        if nbytes > self.max_bytes:
            return  # a single over-cap tile must not flush everything
        expires = (self._clock() + self.ttl_s
                   if self.ttl_s is not None else None)
        self._entries[key] = _Entry(value, nbytes, generation, expires)
        self._bytes += nbytes
        while self._bytes > self.max_bytes and self._entries:
            k, e = next(iter(self._entries.items()))
            self._drop(k, e, "lru")

    def _drop(self, key, entry, reason: str):
        # Caller holds the lock.
        self._entries.pop(key, None)
        self._bytes -= entry.nbytes
        if obs.metrics_enabled():
            CACHE_EVICTIONS.inc(reason=reason)

    # -- invalidation ------------------------------------------------------

    def invalidate_keys(self, keys) -> int:
        """Drop specific entries (live-stream ticks: only the tiles a
        batch touched). Returns how many were present. The same walk as
        ``invalidate_matching``, so a render in flight for a dropped key
        is not cached either."""
        return self.invalidate_matching(frozenset(keys))

    def invalidate_matching(self, keys, window_params=(),
                            windows_only: bool = False) -> int:
        """Drop the entries ``invalidate_keys`` would drop for ``keys``
        plus their window variants (``key + ("w", param)`` for each
        served ``param`` in ``window_params``), or with ``windows_only``
        the window variants alone (a bucket roll), and return the same
        count, without iterating ``keys``: the cache's own keys (bounded
        by its byte cap) are tested against ``keys`` by membership, so a
        set far larger than the cache (a delta's ``TileKeySet``) is
        never enumerated. The tests run outside the lock. A render in
        flight for a matching key is not cached when it lands: it may
        have read the index from before the caller's swap."""
        params = frozenset(str(p) for p in window_params)

        def hit(key) -> bool:
            if isinstance(key, tuple) and len(key) == 7 and key[5] == "w":
                if key[6] in params and key[:5] in keys:
                    return True
                return not windows_only and key in keys
            return not windows_only and key in keys

        with self._lock:
            for key, flight in self._flights.items():
                if hit(key):
                    flight.doomed = True
            snapshot = list(self._entries)
        doomed = [key for key in snapshot if hit(key)]
        n = 0
        with self._lock:
            for key in doomed:
                entry = self._entries.get(key)
                if entry is not None:
                    self._drop(key, entry, "invalidated")
                    n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
