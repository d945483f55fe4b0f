"""Brownout control: an SLO-driven adaptive-fidelity ladder.

The port's copy of heatmap_tpu/serve/degrade.py: the same ladder, the
same shed keys, the same events.

The SLO burn-rate engine (obs/slo.py) knows when latency/staleness
budgets are burning, the wavelet-synopsis tier can serve any coarse
tile at a stamped L-inf error for a fraction of the bytes, and the
admission machinery already sheds with typed 503s — this module closes
the loop between them. :class:`BrownoutController` is a small,
deterministic rung-ladder state machine:

====  ============  ======================================================
rung  name          serving policy
====  ============  ======================================================
0     full          exact bytes, byte-identical to a controller-less app
1     synopsis      coarse zooms answered from decoded synopses (achieved
                    error stamped in ``X-Heatmap-Synopsis``)
2     stale_wide    synopsis zoom ceiling raised (coarser sources upsample
                    into zooms with no natural synopsis) and cache TTLs
                    stretched so serve-stale widens
3     shed          admission tightened (in-flight bound halved) and a
                    deterministic fraction of tile keys shed as typed 503s
====  ============  ======================================================

**Hysteresis.** A step *up* requires the burn signal to sit at or above
``up_threshold`` continuously for ``dwell_s``; a step *down* requires it
at or below ``down_threshold`` continuously for ``hold_s``. Between the
thresholds both timers reset (a dead band holds the current rung), and
every transition restarts the clock — so an oscillating burn signal
moves the ladder at most once per dwell/hold window and never flaps.

**Determinism.** The controller owns no thread and reads no ambient
state: the clock (``clock=time.monotonic``) and the burn source (a
callable returning ``{slo_name: burn}``; default: the installed SLO
engine via :func:`heatmap_tpu_torch.obs.slo.burn_values`) are both injectable,
so tests and the chaos soak pin the whole ladder with a fake clock and
a scripted burn schedule. Shedding at the top rung is a seeded hash of
the tile key (the faults-plane ``hash01``, the same determinism idiom as
retry backoff), never an RNG — the router and every backend agree on
which keys shed without coordination.

**Observability.** Every transition is one edge-triggered
``degrade_step`` event (rung, direction, cause, burn) plus the
``degrade_rung`` gauge; reaching the top rung fires a rate-limited
``brownout`` incident trigger so a flight-recorder bundle captures the
episode. ``snapshot()`` folds into ``/healthz`` and is what the fleet
router reads from backend probes for fleet-wide rung agreement.

Zero-cost-when-off: at rung 0 every policy helper returns the
pass-through value and the serve path's bytes, ETags, cache keys and
TTLs are untouched — pinned by the byte-identity legs in
tests/test_degrade.py, the same contract as tracing and the recorder.
"""

from __future__ import annotations

import threading
import time

from heatmap_tpu_torch import faults, obs
from heatmap_tpu_torch.obs import incident, slo

_registry = obs.get_registry()
DEGRADE_RUNG = _registry.gauge(
    "degrade_rung", "Active brownout rung (0 = full fidelity)")
DEGRADE_STEPS = _registry.counter(
    "degrade_steps_total", "Brownout ladder transitions",
    labelnames=("direction",))
DEGRADE_SHED = _registry.counter(
    "degrade_shed_total", "Tile requests shed by the brownout ladder")

#: Rung names, index == rung. The ladder's top rung defaults to the
#: last entry but can be capped lower per controller.
RUNG_NAMES = ("full", "synopsis", "stale_wide", "shed")
MAX_RUNG = len(RUNG_NAMES) - 1

#: ``--degrade-ladder`` spec keys -> (attribute, parser, validator).
_LADDER_KEYS = {
    "up": ("up_threshold", float, lambda v: v > 0),
    "down": ("down_threshold", float, lambda v: v >= 0),
    "ttl": ("ttl_stretch", float, lambda v: v >= 1.0),
    "shed": ("shed_fraction", float, lambda v: 0.0 <= v <= 1.0),
    "max": ("max_rung", int, lambda v: 1 <= v <= MAX_RUNG),
}


def parse_ladder_spec(spec: str) -> dict:
    """Parse a ``--degrade-ladder`` spec (``up=1.0,down=0.5,ttl=4,
    shed=0.5,max=3``) into BrownoutController kwargs. Raises ValueError
    on unknown keys or out-of-range values (the CLI turns that into a
    SystemExit, same convention as --slo/--chaos specs)."""
    out: dict = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        key, sep, raw = part.partition("=")
        if not sep or key not in _LADDER_KEYS:
            raise ValueError(
                f"unknown ladder knob {key!r} "
                f"(expected {','.join(sorted(_LADDER_KEYS))})")
        attr, conv, ok = _LADDER_KEYS[key]
        try:
            value = conv(raw)
        except ValueError:
            raise ValueError(f"ladder knob {key}={raw!r} is not a number")
        if not ok(value):
            raise ValueError(f"ladder knob {key}={raw} out of range")
        out[attr] = value
    return out


def shed_tile(fraction: float, key: tuple) -> bool:
    """Deterministic shed decision for one tile key: a seeded hash of
    the key against ``fraction``, using the installed faults plane's
    seed (0 without one) — so repeat runs shed the same keys and the
    router agrees with every backend without coordination."""
    if fraction <= 0.0:
        return False
    plane = faults.get_plane()
    seed = plane.seed if plane is not None else 0
    return faults.hash01(seed, "brownout", *map(str, key)) < fraction


def retry_after_jitter(nominal_s: float, path: str, bucket: int) -> int:
    """Seeded jitter for the ``Retry-After`` header on typed 503s: the
    faults/retry.py jitter shape (deterministic ``hash01``, never RNG)
    spread over [0.5, 1.5) x nominal so shed clients don't retry in a
    synchronized thundering herd. ``bucket`` is a coarse time bucket
    (whole seconds) so one client's successive retries re-jitter while
    the value stays deterministic under a seeded plane."""
    plane = faults.get_plane()
    seed = plane.seed if plane is not None else 0
    jitter = 0.5 + faults.hash01(seed, "retry.after", path, bucket)
    return max(1, round(nominal_s * jitter))


class BrownoutController:
    """Hysteresis-guarded rung ladder; see the module docstring.

    Thread-safe: ``poll``/``observe`` serialize under a lock; the policy
    helpers (``force_synopsis``/``ttl_scale``/...) read the rung without
    locking — a plain int read, which is what keeps the rung-0 fast path
    free. ``poll()`` is rate-limited to ``poll_interval_s`` so calling
    it per-request costs one clock read between evaluations.
    """

    def __init__(self, *, up_threshold: float = 1.0,
                 down_threshold: float = 0.5,
                 dwell_s: float = 10.0, hold_s: float = 30.0,
                 max_rung: int = MAX_RUNG, ttl_stretch: float = 4.0,
                 shed_fraction: float = 0.5,
                 poll_interval_s: float = 1.0,
                 burn_source=None, clock=time.monotonic):
        if down_threshold >= up_threshold:
            raise ValueError(
                f"down threshold {down_threshold} must sit below the up "
                f"threshold {up_threshold} (the hysteresis dead band)")
        if dwell_s < 0 or hold_s < 0:
            raise ValueError("dwell/hold must be >= 0 seconds")
        if not 1 <= max_rung <= MAX_RUNG:
            raise ValueError(f"max_rung must be in 1..{MAX_RUNG}")
        if ttl_stretch < 1.0:
            raise ValueError("ttl stretch must be >= 1.0")
        if not 0.0 <= shed_fraction <= 1.0:
            raise ValueError("shed fraction must be in [0, 1]")
        self.up_threshold = float(up_threshold)
        self.down_threshold = float(down_threshold)
        self.dwell_s = float(dwell_s)
        self.hold_s = float(hold_s)
        self.max_rung = int(max_rung)
        self.ttl_stretch = float(ttl_stretch)
        self.shed_fraction = float(shed_fraction)
        self.poll_interval_s = float(poll_interval_s)
        self._burn_source = (burn_source if burn_source is not None
                             else slo.burn_values)
        self._clock = clock
        self._lock = threading.Lock()
        self.rung = 0
        self._high_since: float | None = None
        self._low_since: float | None = None
        self._next_poll: float | None = None
        self._last_burns: dict = {}

    # -- control loop ------------------------------------------------------

    def poll(self, now: float | None = None) -> int:
        """Re-evaluate the burn signal and maybe step the ladder.
        Called from the request path; between poll intervals it is one
        clock read and a compare."""
        now = self._clock() if now is None else now
        with self._lock:
            if self._next_poll is not None and now < self._next_poll:
                return self.rung
            self._next_poll = now + self.poll_interval_s
        return self.observe(self._burn_source() or {}, now)

    def observe(self, burns: dict, now: float) -> int:
        """Feed one burn sample (``{slo_name: burn}``) at ``now`` and
        step the ladder if a dwell/hold window has elapsed. Returns the
        (possibly new) rung."""
        burn = max(burns.values(), default=0.0)
        with self._lock:
            self._last_burns = dict(burns)
            direction = None
            if burn >= self.up_threshold:
                self._low_since = None
                if self._high_since is None:
                    self._high_since = now
                if (now - self._high_since >= self.dwell_s
                        and self.rung < self.max_rung):
                    direction = "up"
            elif burn <= self.down_threshold:
                self._high_since = None
                if self._low_since is None:
                    self._low_since = now
                if (now - self._low_since >= self.hold_s
                        and self.rung > 0):
                    direction = "down"
            else:
                # Dead band: hold the rung, restart both windows.
                self._high_since = self._low_since = None
            if direction is None:
                return self.rung
            from_rung = self.rung
            self.rung = from_rung + (1 if direction == "up" else -1)
            # A fresh dwell/hold must elapse before the next step — this
            # reset is the at-most-one-step-per-window guarantee.
            self._high_since = self._low_since = now
            rung = self.rung
        cause = (max(burns, key=burns.get) if burns and direction == "up"
                 else "recovery")
        self._transition(from_rung, rung, direction, cause, burn)
        return rung

    def _transition(self, from_rung: int, rung: int, direction: str,
                    cause: str, burn: float) -> None:
        if obs.metrics_enabled():
            DEGRADE_RUNG.set(float(rung))
            DEGRADE_STEPS.inc(direction=direction)
        obs.emit("degrade_step", rung=int(rung), from_rung=int(from_rung),
                 direction=direction, cause=cause,
                 burn=round(float(burn), 4))
        if direction == "up" and rung == self.max_rung:
            # Top of the ladder: capture the episode. The incident
            # manager rate-limits per kind, so a long brownout flushes
            # one bundle, not one per poll.
            incident.trigger(
                "brownout",
                detail=f"rung {rung} ({RUNG_NAMES[rung]}): "
                       f"burn {burn:.3g} via {cause}")

    # -- serving policy ----------------------------------------------------

    def force_synopsis(self) -> bool:
        """Rung >= 1: coarse zooms answer from synopses."""
        return self.rung >= 1

    def stretch_synopsis(self) -> bool:
        """Rung >= 2: raise the synopsis zoom ceiling (coarser sources
        upsample into zooms with no natural synopsis)."""
        return self.rung >= 2

    def ttl_scale(self) -> float:
        """Rung >= 2: multiply cache TTLs so serve-stale widens."""
        return self.ttl_stretch if self.rung >= 2 else 1.0

    def inflight_limit(self, base: int | None) -> int | None:
        """Rung == max: halve the admission bound (an unbounded app
        stays unbounded — there is nothing to tighten)."""
        if base is None or self.rung < self.max_rung:
            return base
        return max(1, base // 2)

    def shed(self, key: tuple) -> bool:
        """Rung == max: deterministic fractional shed by tile key."""
        return (self.rung >= self.max_rung
                and shed_tile(self.shed_fraction, key))

    def snapshot(self) -> dict:
        """JSON-ready state for /healthz and router probes."""
        with self._lock:
            rung = self.rung
            burns = {k: round(float(v), 4)
                     for k, v in sorted(self._last_burns.items())}
        return {
            "rung": rung,
            "rung_name": RUNG_NAMES[rung],
            "max_rung": self.max_rung,
            "shed_fraction": self.shed_fraction,
            "burns": burns,
            "thresholds": {"up": self.up_threshold,
                           "down": self.down_threshold},
            "dwell_s": self.dwell_s,
            "hold_s": self.hold_s,
        }


def controller_from_flags(enabled: bool, dwell_s: float, hold_s: float,
                          ladder_spec: str = "",
                          **kwargs) -> BrownoutController | None:
    """Build the controller the CLI/fleet way: ``None`` when disabled
    (the default — brownout is opt-in), else a controller from the
    dwell/hold knobs plus a parsed ladder spec. Raises ValueError on a
    bad spec or out-of-range knob."""
    if not enabled:
        return None
    params = parse_ladder_spec(ladder_spec or "")
    params.update(kwargs)
    return BrownoutController(dwell_s=dwell_s, hold_s=hold_s, **params)
