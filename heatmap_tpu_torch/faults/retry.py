"""Unified retry policy: bounded exponential backoff + full jitter + deadline.

The port's copy of heatmap_tpu/faults/retry.py (stdlib only). Backoff
for attempt *k* is ``min(cap_s, base_s * 2**(k-1)) * U`` with *full
jitter* ``U`` in [0, 1), deterministic: ``plane.hash01(seed, site, key,
attempt)``, so a seeded chaos run sleeps the same schedule every time.
The installed plane's ``backoff_scale`` multiplies every sleep (tests
set it to 0).

Only *transient* errors are retried (``RETRYABLE`` = OSError +
RuntimeError, which covers real I/O failures and :class:`InjectedFault`);
data errors (ValueError etc.) propagate at once. Both helpers run the
plane's fault check for their site *before* the guarded operation, so an
injected fault never leaves a half-executed write behind.

``retry_call`` guards one operation. ``resumable_iter`` guards a whole
deterministic stream: on a transient mid-stream failure it rebuilds the
iterator and skips the prefix already delivered; its
consecutive-failure budget resets whenever an item is delivered. Each
retry counts in ``io_retries_total{site}``.
"""

from __future__ import annotations

import dataclasses
import time

from heatmap_tpu_torch.faults.plane import check, get_plane, hash01

# Transient error classes worth retrying. InjectedFault is a
# RuntimeError; OSError covers real filesystem/network failures.
RETRYABLE = (OSError, RuntimeError)


class NonRetryable:
    """Marker mixin: an error that matches RETRYABLE by class but is
    deterministic (a missing dependency, bad config) — raised through the
    retry machinery without burning attempts or sleeping."""


#: Hard ceiling on iterator rebuilds at one stream position
#: (resumable_iter). The per-policy attempt budget already bounds a
#: contiguous failure window under the shipped POLICIES table, but a
#: permissive caller policy (retries=10**9, deadline_s=None) would
#: otherwise rebuild a deterministically-poisoned batch forever; this
#: cap turns that pathology into a typed PoisonedStream regardless of
#: how generous the policy is.
MAX_REBUILDS_PER_POSITION = 8


class PoisonedStream(NonRetryable, RuntimeError):
    """A stream failed :data:`MAX_REBUILDS_PER_POSITION` times at the
    same position — the batch is deterministically poisoned, not
    transient, so rebuilding again cannot help."""

    def __init__(self, site: str, position: int, rebuilds: int,
                 last_error: BaseException):
        super().__init__(
            f"{site}: stream poisoned at position {position} — "
            f"{rebuilds} rebuilds all failed there "
            f"(last: {last_error!r})")
        self.site = site
        self.position = int(position)
        self.rebuilds = int(rebuilds)
        self.last_error = last_error


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """retries = re-executions allowed after the first failure;
    deadline_s bounds one contiguous failure window (None = unbounded)."""

    retries: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    deadline_s: float | None = 30.0


DEFAULT_POLICY = RetryPolicy()

# Per-site defaults (the docs/robustness.md policy table). Serving-path
# sites get zero retries: the degradation machinery (stale-if-error,
# typed 503) owns those failures, and a request handler must not sleep.
POLICIES = {
    "source.read": RetryPolicy(retries=4, base_s=0.05, cap_s=2.0,
                               deadline_s=60.0),
    "sink.write": RetryPolicy(retries=4, base_s=0.05, cap_s=2.0,
                              deadline_s=60.0),
    "journal.append": RetryPolicy(retries=3, base_s=0.02, cap_s=0.5,
                                  deadline_s=10.0),
    "compact.publish": RetryPolicy(retries=3, base_s=0.02, cap_s=0.5,
                                   deadline_s=10.0),
    "shard.compute": RetryPolicy(retries=2, base_s=0.05, cap_s=2.0,
                                 deadline_s=None),
    "tile.render": RetryPolicy(retries=0, base_s=0.0, cap_s=0.0,
                               deadline_s=None),
    "http.request": RetryPolicy(retries=0, base_s=0.0, cap_s=0.0,
                                deadline_s=None),
    "multihost.heartbeat": RetryPolicy(retries=0, base_s=0.0, cap_s=0.0,
                                       deadline_s=None),
    # Ingest-loop boundaries. A tick is idempotent end to end (the
    # journal's content hash turns a replay into a no-op), so retrying
    # the whole tick is safe; publish is pure cache invalidation +
    # artifact re-read, also safe to repeat. Short caps: a standing
    # loop must shed a poisoned tick quickly rather than stall the
    # queue behind a long backoff.
    "ingest.tick": RetryPolicy(retries=2, base_s=0.02, cap_s=0.5,
                               deadline_s=10.0),
    "ingest.publish": RetryPolicy(retries=3, base_s=0.02, cap_s=0.5,
                                  deadline_s=10.0),
    # Provisional synopsis publish (early serving). Best-effort by
    # contract — the exact apply supersedes it either way — so the
    # budget is small and the loop swallows a terminal failure instead
    # of dying.
    "ingest.synopsis": RetryPolicy(retries=2, base_s=0.02, cap_s=0.5,
                                   deadline_s=10.0),
    # Host->device feeder transfer (pipeline/feeder.py). device_put is
    # idempotent (nothing downstream saw the batch), so re-feeding is
    # always safe; short caps because the feeder thread stalling just
    # degrades overlap back to synchronous transfer.
    "feeder.put": RetryPolicy(retries=2, base_s=0.02, cap_s=0.5,
                              deadline_s=10.0),
    # Orphaned-shard re-execution on a surviving host. The shard
    # already failed once on the dead host, so the retry budget here
    # guards only the survivor's own transients; a shard that also
    # fails on the survivor should surface quickly rather than wander
    # the fleet.
    "elastic.reassign": RetryPolicy(retries=2, base_s=0.05, cap_s=2.0,
                                    deadline_s=None),
    # Fleet router forward: exactly one retry, and it lands on the
    # *next* replica in rendezvous order, never the same backend — so
    # base_s stays 0 (no sleep in a request handler; the failover IS
    # the backoff). Connection failures only; HTTP status codes pass
    # through untouched.
    "router.forward": RetryPolicy(retries=1, base_s=0.0, cap_s=0.0,
                                  deadline_s=None),
    # Active health probes are themselves the retry loop (the prober
    # re-probes every interval); a failed probe just feeds the breaker.
    "backend.probe": RetryPolicy(retries=0, base_s=0.0, cap_s=0.0,
                                 deadline_s=None),
    # tilefs mmap open. Zero retries: a torn/unreadable tilefs file is
    # deterministic, and the store's heap-npz fallback for that zoom IS
    # the recovery (serving stays byte-identical; the offline sweep
    # owns quarantining the file).
    "tilefs.read": RetryPolicy(retries=0, base_s=0.0, cap_s=0.0,
                               deadline_s=None),
    # Disk-cache write-through. Zero retries: the tile was already
    # rendered when the fill runs, so a failed write is just a skipped
    # optimization — never worth sleeping for on the serve path.
    "diskcache.write": RetryPolicy(retries=0, base_s=0.0, cap_s=0.0,
                                   deadline_s=None),
    # Write-plane boundaries (heatmap_tpu/writeplane/). A per-range
    # sub-apply is idempotent end to end (the range journal's content
    # hash), so retrying the whole apply is safe; short caps because a
    # stalling pump backs the router's bounded queue up — shed a
    # poisoned sub-batch quickly and let the replay heal it.
    "writeplane.append": RetryPolicy(retries=2, base_s=0.02, cap_s=0.5,
                                     deadline_s=10.0),
    # The manifest-epoch flip is atomic (tmp + rename, twice), so a
    # retried publish lands the same epoch bytes exactly once — same
    # stance as compact.publish.
    "writeplane.publish": RetryPolicy(retries=3, base_s=0.02, cap_s=0.5,
                                      deadline_s=10.0),
    # Re-split is rare, coordinator-only, and heavyweight (it compacts
    # the hot range first); one retry covers a transient, and a failed
    # rebalance is safe to abandon — the skew check re-fires later and
    # the sweep quarantines any orphan child range.
    "writeplane.rebalance": RetryPolicy(retries=1, base_s=0.05, cap_s=2.0,
                                        deadline_s=None),
}


def policy_for(site: str) -> RetryPolicy:
    return POLICIES.get(site, DEFAULT_POLICY)


def backoff_s(site: str, key, attempt: int, *, base_s: float,
              cap_s: float) -> float:
    """Full-jitter exponential backoff for retry ``attempt`` (1-based),
    deterministic under the installed plane's seed and scaled by its
    ``backoff_scale``."""
    if base_s <= 0 or attempt < 1:
        return 0.0
    plane = get_plane()
    seed = plane.seed if plane is not None else 0
    scale = plane.backoff_scale if plane is not None else 1.0
    exp = min(cap_s, base_s * (2.0 ** (attempt - 1)))
    return exp * hash01(seed, "backoff", site, key, attempt) * scale


def sleep_backoff(site: str, key, attempt: int, *, base_s: float,
                  cap_s: float) -> float:
    """Compute + sleep the backoff; returns the seconds slept. The only
    retry sleep in the package."""
    delay = backoff_s(site, key, attempt, base_s=base_s, cap_s=cap_s)
    if delay > 0:
        time.sleep(delay)
    return delay


def retry_call(fn, *args, site: str, key=None,
               policy: RetryPolicy | None = None, clock=time.monotonic):
    """Run ``fn(*args)`` under the site's fault check + retry policy.

    Retries RETRYABLE errors with backoff until the policy's attempt or
    deadline budget is spent, then re-raises the last error. ``fn`` must
    be safe to re-execute (atomic or idempotent).
    """
    if policy is None:
        policy = policy_for(site)
    attempt = 0
    start = clock()
    while True:
        try:
            check(site, key)
            return fn(*args)
        except RETRYABLE as e:
            if isinstance(e, NonRetryable):
                raise
            attempt += 1
            if attempt > policy.retries:
                raise
            if (policy.deadline_s is not None
                    and clock() - start >= policy.deadline_s):
                raise
            from heatmap_tpu_torch import obs

            obs.record_io_retry(site)
            sleep_backoff(site, key, attempt,
                          base_s=policy.base_s, cap_s=policy.cap_s)


def resumable_iter(make_iter, *, site: str, key=None,
                   policy: RetryPolicy | None = None, clock=time.monotonic,
                   max_rebuilds: int = MAX_REBUILDS_PER_POSITION):
    """Yield from ``make_iter()`` with transparent retry-with-resume.

    On a retryable failure (including an injected fault at the per-item
    site check) the iterator is rebuilt and the already-delivered prefix
    replayed and discarded — identical bytes, because sources iterate
    deterministically. Delivered items reset the attempt/deadline
    window; non-retryable errors and exhausted budgets propagate.

    The per-delivery window reset is what lets a long stream absorb
    many isolated transients, but it also means the *policy* never
    bounds total rebuilds of one poisoned position when the caller's
    policy is permissive. ``max_rebuilds`` is the independent
    poison-batch bound: once that many consecutive rebuilds fail at the
    same position the stream raises :class:`PoisonedStream`
    (NonRetryable) instead of rebuilding forever.
    """
    if policy is None:
        policy = policy_for(site)
    delivered = 0
    attempt = 0
    window_start = None
    poison_position = None  # stream position of the last failure
    poison_rebuilds = 0  # consecutive failures at that position
    while True:
        try:
            it = make_iter()
            for _ in range(delivered):
                next(it)  # replay prefix: no fault checks, no re-delivery
            while True:
                check(site, key)
                try:
                    item = next(it)
                except StopIteration:
                    return
                delivered += 1
                attempt = 0
                window_start = None
                yield item
        except StopIteration:
            return  # stream ended during replay
        except RETRYABLE as e:
            if isinstance(e, NonRetryable):
                raise
            if delivered == poison_position:
                poison_rebuilds += 1
            else:
                poison_position = delivered
                poison_rebuilds = 1
            if poison_rebuilds >= max_rebuilds:
                raise PoisonedStream(site, delivered, poison_rebuilds,
                                     e) from e
            attempt += 1
            now = clock()
            if window_start is None:
                window_start = now
            if attempt > policy.retries:
                raise
            if (policy.deadline_s is not None
                    and now - window_start >= policy.deadline_s):
                raise
            from heatmap_tpu_torch import obs

            obs.record_io_retry(site)
            sleep_backoff(site, key, attempt,
                          base_s=policy.base_s, cap_s=policy.cap_s)
