"""Process-wide deterministic fault-injection plane.

The port's copy of heatmap_tpu/faults/plane.py (stdlib only). One
registry, a closed site allowlist, zero cost when off: guarded
boundaries call ``check(site, key=...)`` at the top of the operation;
with no plane installed that is one module-global read. With a plane
installed, rules decide, purely as a function of ``(seed, site, key,
per-rule check index)``, whether the check raises
:class:`InjectedFault`, so two runs with the same plane and the same
call sequence inject the same faults at the same places.

The port's sites: ``source.read``, ``sink.write`` (level writes of the
``arrays:`` sink), ``shard.compute`` (the site ``FaultInjector`` maps
onto) and ``feeder.put`` (each host->device transfer of
pipeline/feeder.py); the allowlist keeps the JAX package's other sites
so that a chaos spec reads the same in both packages.

Rule shapes: count rules fail the first N matching checks
(``spacing=1``) or every K-th check until N fired (``spacing=K``);
probability rules fire when a seeded hash of the check index lands under
``p``. Checks run before the guarded operation touches anything, so
retrying after an injected fault is idempotent by construction. Every
fired fault is recorded through ``obs.record_fault`` (a
``fault_injected`` event and the ``faults_injected_total{site}``
counter).
"""

from __future__ import annotations

import hashlib
import os
import threading

ENV_VAR = "HEATMAP_TPU_CHAOS"

SITES = (
    "source.read",
    "sink.write",
    "journal.append",
    "compact.publish",
    "shard.compute",
    "tile.render",
    "http.request",
    "multihost.heartbeat",
    "ingest.tick",
    "ingest.publish",
    "ingest.synopsis",
    "feeder.put",
    "elastic.reassign",
    "router.forward",
    "backend.probe",
    "tilefs.read",
    "diskcache.write",
    "writeplane.append",
    "writeplane.publish",
    "writeplane.rebalance",
)
_SITE_SET = frozenset(SITES)


class InjectedFault(RuntimeError):
    """A fault fired by the injection plane (transient by design).

    ``trace_id`` is the ambient trace at injection time (None with
    tracing off), the identity obs.events stamps on the matching
    ``fault_injected`` event.
    """

    def __init__(self, site: str, key=None, seq: int = 0):
        self.site = site
        self.key = key
        self.seq = seq
        from heatmap_tpu_torch.obs import tracing

        ids = tracing.current_ids()
        self.trace_id = ids[0] if ids else None
        at = f"{site}@{key}" if key is not None else site
        super().__init__(f"injected fault #{seq} at {at}")


def hash01(seed, *parts) -> float:
    """Deterministic uniform-ish float in [0, 1) from (seed, *parts).

    Shared by probability rules and the retry jitter so a chaos run is a
    pure function of its seed — no RNG state threads through the
    pipeline.
    """
    msg = "|".join(str(p) for p in (seed, *parts)).encode()
    digest = hashlib.blake2b(msg, digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


class _Rule:
    __slots__ = ("site", "key", "count", "left", "spacing", "prob", "checks")

    def __init__(self, site, key, count, spacing, prob):
        self.site = site
        self.key = key
        self.count = count
        self.left = count
        self.spacing = spacing
        self.prob = prob
        self.checks = 0  # matching checks seen (fired or not)

    def describe(self) -> str:
        target = self.site if self.key is None else f"{self.site}@{self.key}"
        if self.prob is not None:
            return f"{target}=p{self.prob}"
        if self.spacing != 1:
            return f"{target}={self.count}x{self.spacing}"
        return f"{target}={self.count}"


class FaultPlane:
    """A seeded, site-keyed set of fault rules with injection counters.

    ``backoff_scale`` multiplies every retry backoff computed while this
    plane is installed (``faults.retry``); chaos tests set it to 0 so
    hundreds of injected faults retry without sleeping.
    """

    def __init__(self, seed: int = 0, backoff_scale: float = 1.0):
        self.seed = int(seed)
        self.backoff_scale = float(backoff_scale)
        self._lock = threading.Lock()
        self._rules: list = []
        self._counts: dict = {}
        self._seq = 0

    def add_rule(self, site: str, *, count: int | None = None,
                 prob: float | None = None, key=None, spacing: int = 1):
        """Register one rule; exactly one of count/prob must be given."""
        if site not in _SITE_SET:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"valid sites: {', '.join(SITES)}")
        if (count is None) == (prob is None):
            raise ValueError("exactly one of count= or prob= is required")
        if count is not None and count < 1:
            raise ValueError("count must be >= 1")
        if prob is not None and not 0.0 < prob <= 1.0:
            raise ValueError("prob must be in (0, 1]")
        if spacing < 1:
            raise ValueError("spacing must be >= 1")
        with self._lock:
            self._rules.append(_Rule(site, key, count, spacing, prob))
        return self

    def check(self, site: str, key=None):
        """Raise InjectedFault if a rule fires for this (site, key) check."""
        if site not in _SITE_SET:
            raise ValueError(f"unknown fault site {site!r}")
        fired = None
        with self._lock:
            for rule in self._rules:
                if rule.site != site:
                    continue
                if rule.key is not None and (
                        key is None or str(rule.key) != str(key)):
                    continue
                n = rule.checks
                rule.checks += 1
                if rule.prob is not None:
                    if hash01(self.seed, site, rule.key, key, n) >= rule.prob:
                        continue
                else:
                    if rule.left <= 0 or n % rule.spacing:
                        continue
                    rule.left -= 1
                fired = (self._seq, rule.describe())
                self._seq += 1
                self._counts[site] = self._counts.get(site, 0) + 1
                break
        if fired is not None:
            seq, rule_desc = fired
            from heatmap_tpu_torch import obs

            obs.record_fault(site, seq, key=key, rule=rule_desc)
            raise InjectedFault(site, key, seq)

    @property
    def injected(self) -> int:
        """Total faults fired so far."""
        with self._lock:
            return self._seq

    def counts(self) -> dict:
        """Faults fired per site, ``{site: n}`` (only sites that fired)."""
        with self._lock:
            return dict(self._counts)


def parse_spec(spec: str) -> FaultPlane:
    """Build a FaultPlane from a comma-separated spec string.

    Grammar (tokens joined by ","):

    - ``seed=S``        plane seed (jitter + probability rules)
    - ``scale=F``       retry-backoff multiplier (0 = no sleeps)
    - ``SITE=N``        fail the first N checks at SITE
    - ``SITE=NxK``      fire N faults, one every K-th check
    - ``SITE=pP``       fire each check with probability P (seeded)
    - ``SITE@KEY=...``  same rule shapes, scoped to one key

    Example: ``seed=7,scale=0,source.read=40x3,tile.render=p0.25``.
    """
    seed, scale, rules = 0, 1.0, []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        name, sep, value = token.partition("=")
        if not sep or not value:
            raise ValueError(f"bad chaos token {token!r} (want name=value)")
        if name == "seed":
            seed = int(value)
            continue
        if name == "scale":
            scale = float(value)
            continue
        site, _, key = name.partition("@")
        key = key or None
        if value.startswith("p"):
            rules.append(dict(site=site, key=key, prob=float(value[1:])))
        elif "x" in value:
            count, _, spacing = value.partition("x")
            rules.append(dict(site=site, key=key, count=int(count),
                              spacing=int(spacing)))
        else:
            rules.append(dict(site=site, key=key, count=int(value)))
    plane = FaultPlane(seed=seed, backoff_scale=scale)
    for rule in rules:
        plane.add_rule(rule.pop("site"), **rule)
    return plane


_plane: FaultPlane | None = None


def install(plane: FaultPlane | None):
    """Install (or clear, with None) the process-wide fault plane."""
    global _plane
    _plane = plane


def get_plane() -> FaultPlane | None:
    return _plane


def check(site: str, key=None):
    """Module-level check: one global read when no plane is installed."""
    plane = _plane
    if plane is not None:
        plane.check(site, key)


def install_spec(spec: str) -> FaultPlane:
    """Parse + install; returns the new plane."""
    plane = parse_spec(spec)
    install(plane)
    return plane


def install_from_env(cli_spec: str | None = None) -> FaultPlane | None:
    """Install from an explicit --chaos spec, else ``HEATMAP_TPU_CHAOS``.

    No-op (returns the current plane, usually None) when neither is set.
    """
    spec = cli_spec if cli_spec is not None else os.environ.get(ENV_VAR)
    if not spec:
        return _plane
    return install_spec(spec)
