"""Popularity-driven cache pre-warming from the http_request event log.

The port's copy of heatmap_tpu/tilefs/prewarm.py: the same plan for
the same event log.

Tile traffic is Zipf-shaped (the load generator models it explicitly:
80/20 over a shuffled universe), so yesterday's head predicts today's:
replaying the top-K most-popular tile paths into a freshly started (or
just-reloaded) backend collapses cold-start p99 to warm-path latency
for the requests that dominate the distribution.

``build_plan`` folds one or more JSONL event logs (``obs.EventLog``
output) into a deterministic ordered plan: per-path scores are
exponentially decayed by *event recency* — position in the log, not
wall-clock, so a fixed log always yields the identical plan on every
backend of a fleet (each one computes it locally from the same file; no
coordination, no clock reads) — ties broken lexically. ``warm`` then
drives the plan through ``ServeApp.handle`` under a time + byte budget,
filling every tier (heap ``TileCache`` and the disk tier behind it) via
the normal render path, and emits one ``prewarm_done`` event plus
``prewarm_*`` metrics.
"""

from __future__ import annotations

import dataclasses
import time

from heatmap_tpu_torch import obs

_registry = obs.get_registry()
PREWARM_KEYS = _registry.counter(
    "prewarm_keys_total", "Plan keys replayed into the caches",
    labelnames=("result",))  # result = warmed | error
PREWARM_BYTES = _registry.counter(
    "prewarm_bytes_total", "Response bytes rendered while pre-warming")
PREWARM_RUNS = _registry.counter(
    "prewarm_runs_total", "Pre-warm passes, by trigger",
    labelnames=("source",))  # source = startup | reload


@dataclasses.dataclass
class PrewarmConfig:
    """Everything a backend needs to warm itself (cli/fleet flags)."""

    events: tuple = ()       # JSONL event-log paths, oldest first
    top_k: int = 64
    half_life: float = 512.0  # decay half-life, in EVENTS (not seconds)
    budget_s: float = 10.0
    budget_bytes: int = 64 << 20


def build_plan(event_paths, *, top_k: int = 64,
               half_life: float = 512.0) -> list[str]:
    """Ordered tile paths to replay: the decayed-frequency head.

    Reads ``http_request`` events from ``event_paths`` (in the given
    order, oldest log first), keeps 2xx tile requests, and scores each
    path by ``sum(0.5 ** (age / half_life))`` where ``age`` counts
    events back from the newest — a purely positional decay, so the
    plan is a deterministic function of the log bytes. Returns at most
    ``top_k`` paths, best first, ties broken by path.
    """
    requests: list[str] = []
    for log_path in event_paths:
        try:
            records = obs.read_events(log_path)
        except OSError:
            continue
        for rec in records:
            if rec.get("event") != "http_request":
                continue
            path = rec.get("path")
            status = rec.get("status", 0)
            if not path or not path.startswith("/tiles/"):
                continue
            if not 200 <= int(status) < 300:
                continue
            requests.append(path.partition("?")[0]
                            + ("?synopsis=1" if "synopsis=1" in path
                               else ""))
    n = len(requests)
    scores: dict[str, float] = {}
    for i, path in enumerate(requests):
        scores[path] = scores.get(path, 0.0) + 0.5 ** ((n - 1 - i)
                                                       / half_life)
    ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
    return [path for path, _ in ranked[: max(0, int(top_k))]]


def warm(app, plan, *, budget_s: float = 10.0,
         budget_bytes: int = 64 << 20, source: str = "startup",
         clock=time.monotonic) -> dict:
    """Replay ``plan`` through ``app.handle`` until done or out of
    budget. Every request goes through the full serve path, so the heap
    cache, the disk tier, and any synopsis decode all fill exactly as a
    real client would fill them. Returns (and emits) the summary."""
    t0 = clock()
    counting = obs.metrics_enabled()
    keys = errors = 0
    nbytes = 0
    exhausted = False
    for path in plan:
        if clock() - t0 >= budget_s or nbytes >= budget_bytes:
            exhausted = True
            break
        try:
            res = app.handle("GET", path)
            status = int(res[0])
            body = res[2] if len(res) > 2 else b""
        except Exception:
            status, body = 599, b""
        if 200 <= status < 300:
            keys += 1
            nbytes += len(body) if body else 0
            if counting:
                PREWARM_KEYS.inc(result="warmed")
        else:
            errors += 1
            if counting:
                PREWARM_KEYS.inc(result="error")
    seconds = clock() - t0
    if counting:
        PREWARM_RUNS.inc(source=source)
        if nbytes:
            PREWARM_BYTES.inc(nbytes)
    obs.emit("prewarm_done", keys=keys, seconds=round(seconds, 6),
             bytes=int(nbytes), errors=errors, planned=len(plan),
             budget_exhausted=exhausted, source=source)
    return {"keys": keys, "planned": len(plan), "seconds": seconds,
            "bytes": int(nbytes), "errors": errors,
            "budget_exhausted": exhausted, "source": source}
