"""Streaming micro-batches: a live window raster with time decay.

Port of heatmap_tpu/streaming.py (BASELINE.md config 4). The live
heatmap is a dense window raster resident on the device; each
micro-batch is one update ``raster = decay^dt * raster + bin(batch)``
done in place on that tensor (the JAX package donates the buffer to a
jitted step instead), so the only host traffic is the incoming points.
Decay is exponential with a configurable half-life, applied by the
stream time elapsed since the previous batch.

The binning is ``ops.histogram.bin_points_window``: on the card "auto"
is the window-histogram kernel for windows up to 256x256 cells and the
bucketed partitioned kernel above. The decay factor is one host scalar
a tick (:func:`decay_factor`); the multiply and add are plain torch ops
that write the raster in place, as they are XLA ops outside any kernel
in the JAX package.

Float policy: f32 accumulation is exact for counts < 2^24 per cell and
decayed streams are bounded by ``incoming_rate * half_life / ln 2``;
pass ``acc_dtype=torch.float64`` for extreme cell densities. The
row-sharded multi-device step is not ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from heatmap_tpu_torch import obs
from heatmap_tpu_torch.devices import resolve_device
from heatmap_tpu_torch.ops.histogram import Window, bin_points_window


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static stream parameters."""

    window: Window
    half_life_s: float = 3600.0
    proj_dtype: torch.dtype = torch.float32
    acc_dtype: torch.dtype = torch.float32
    #: Pad every micro-batch to this many points (one shape for the whole
    #: stream; batches longer than this raise). None = no padding.
    pad_to: int | None = None
    #: Binning backend (ops.histogram): "xla", "pallas", "partitioned"
    #: or "auto" (by device and window size).
    backend: str = "auto"

    @property
    def decay_rate(self) -> float:
        """Per-second multiplicative decay exponent: 2^(-dt/half_life)."""
        return math.log(2.0) / self.half_life_s


def decay_factor(dt_s: float, config: StreamConfig) -> float:
    """``exp(-decay_rate * dt)`` as the JAX package's traced ops compute
    it, in ``config.acc_dtype``: ``dt`` cast to that dtype, one multiply
    and one ``exp`` in it. Computed on the host (a CPU tensor op), so the
    card and the CPU scale by the same number; on the card's own ``exp``
    the two may differ by an ulp a tick."""
    dt = torch.tensor(dt_s, dtype=config.acc_dtype)
    return float(torch.exp(dt * -float(config.decay_rate)))


def make_update_step(config: StreamConfig, mesh=None):
    """Build the micro-batch step.

    Returns ``step(raster, lat, lon, dt_s, weights, valid) -> raster``,
    which updates ``raster`` in place on its device and returns it.
    ``dt_s`` is the stream time (seconds, a float) since the previous
    batch; the decay is :func:`decay_factor`.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the row-sharded stream step is not ported yet (ROADMAP "
            "Queue 1 item 7, parallel/); use mesh=None")
    window = config.window

    def step(raster, lat, lon, dt_s, weights, valid):
        decay = decay_factor(dt_s, config)
        fresh = bin_points_window(
            lat, lon, window,
            weights=weights,
            valid=valid,
            proj_dtype=config.proj_dtype,
            dtype=raster.dtype,
            backend=config.backend,
        )
        if raster.dtype == torch.float32:
            # XLA fuses raster * decay + fresh into one multiply-add with
            # a single rounding. The float64 product of two float32
            # values is exact, so the float64 sum rounded once to float32
            # gives the same bits (except where that sum sits exactly on
            # a float32 rounding midpoint), on the card and the CPU alike.
            return raster.copy_(torch.add(fresh.double(), raster.double(),
                                          alpha=decay))
        return raster.mul_(decay).add_(fresh)

    return step


class HeatmapStream:
    """Stateful micro-batch driver around the update step.

    Batches carry stream timestamps (seconds, monotone non-decreasing);
    the state decays by the elapsed time since the previous batch, so
    replaying the same timestamped batches reproduces the same raster
    (deterministic resume: ``state_dict``/``load_state_dict``,
    ``checkpoint``/``restore``). The raster lives on ``device``: the
    card unless the caller asks for the CPU.
    """

    def __init__(self, config: StreamConfig, mesh=None, device="cuda"):
        self.config = config
        self._step = make_update_step(config, mesh=mesh)
        self.device = resolve_device(device)
        self.raster = torch.zeros(config.window.shape, dtype=config.acc_dtype,
                                  device=self.device)
        self.t: float | None = None
        self.n_batches = 0

    def update(self, lat, lon, t: float, weights=None):
        """Consume one micro-batch stamped at stream time ``t``.

        Batches are padded (masked invalid) to ``config.pad_to`` when
        set. Padding happens on the host, then each column crosses to
        the device in one copy.
        """
        if self.t is not None and t < self.t:
            raise ValueError(f"stream time went backwards: {t} < {self.t}")
        dt = 0.0 if self.t is None else t - self.t
        lat = np.asarray(lat)
        lon = np.asarray(lon)
        n = lat.shape[0]
        target = self.config.pad_to
        if target is not None and n > target:
            raise ValueError(f"batch of {n} points exceeds pad_to={target}")
        valid = None
        if target is not None and target != n:
            pad = target - n
            lat = np.concatenate([lat, np.zeros(pad, lat.dtype)])
            lon = np.concatenate([lon, np.zeros(pad, lon.dtype)])
            valid = np.arange(target) < n
            if weights is not None:
                weights = np.concatenate(
                    [np.asarray(weights), np.zeros(pad, np.asarray(weights).dtype)]
                )
        dev = self.device
        self._step(
            self.raster,
            torch.as_tensor(lat, device=dev),
            torch.as_tensor(lon, device=dev),
            dt,
            None if weights is None else torch.as_tensor(
                np.asarray(weights), device=dev),
            None if valid is None else torch.as_tensor(valid, device=dev),
        )
        self.t = t
        self.n_batches += 1
        if obs.metrics_enabled():
            obs.STREAM_POINTS.inc(int(n))
            obs.STREAM_BATCHES.inc()
            obs.STREAM_TIME.set(float(t))
        return self

    def snapshot(self) -> np.ndarray:
        """Device -> host copy of the current decayed raster."""
        return self.raster.to("cpu", copy=True).numpy()

    def state_dict(self) -> dict:
        return {
            "raster": self.snapshot(),
            "t": self.t,
            "n_batches": self.n_batches,
        }

    def checkpoint(self, manager, weighted: bool | None = None) -> str:
        """Atomic checkpoint via utils.checkpoint.CheckpointManager,
        numbered by batches consumed; the same file the JAX package's
        ``HeatmapStream.checkpoint`` writes.

        ``weighted`` records the ingest semantics (value sums vs
        counts) so a resume under the other mode fails loudly instead
        of blending counted and weighted mass in one raster; None skips
        recording (library callers managing their own semantics)."""
        w = self.config.window
        meta = {"t": self.t, "n_batches": self.n_batches,
                "window": [int(w.zoom), int(w.row0), int(w.col0)]}
        if weighted is not None:
            meta["weighted"] = bool(weighted)
        return manager.save(self.n_batches, {"raster": self.snapshot()}, meta)

    def restore(self, manager, step: int | None = None,
                weighted: bool | None = None):
        """Load the latest (or a given) checkpoint into this stream.

        Validates the checkpoint's window ORIGIN, not just its shape:
        a same-shaped raster restored into a shifted window (e.g.
        --auto-bounds over a file whose extent moved) would silently
        paint the old mass at the wrong place on the map. ``weighted``
        (when given AND recorded in the checkpoint) must match the
        recorded ingest semantics — resuming a weighted stream as a
        counted one would blend value-sums and counts in one raster.
        """
        arrays, meta = manager.load(step)
        w = self.config.window
        ck_win = meta.get("window")  # absent in pre-origin checkpoints
        if ck_win is not None and list(ck_win) != [int(w.zoom),
                                                   int(w.row0),
                                                   int(w.col0)]:
            raise ValueError(
                f"checkpoint window (zoom,row0,col0)={tuple(ck_win)} != "
                f"stream window {(w.zoom, w.row0, w.col0)} — the data's "
                "bounds changed (e.g. --auto-bounds over a grown file); "
                "restart with fixed --lat/--lon flags or a fresh "
                "checkpoint dir"
            )
        ck_weighted = meta.get("weighted")
        if (weighted is not None and ck_weighted is not None
                and bool(weighted) != bool(ck_weighted)):
            raise ValueError(
                f"checkpoint was written by a "
                f"{'weighted' if ck_weighted else 'counted'} stream but "
                f"this resume is {'weighted' if weighted else 'counted'} "
                "— rerun with the matching --weighted setting or a "
                "fresh checkpoint dir"
            )
        return self.load_state_dict({
            "raster": arrays["raster"],
            "t": meta["t"],
            "n_batches": meta["n_batches"],
        })

    def load_state_dict(self, state: dict):
        # A copy: the stream updates its raster in place.
        raster = torch.tensor(np.asarray(state["raster"]),
                              dtype=self.config.acc_dtype)
        if tuple(raster.shape) != tuple(self.config.window.shape):
            raise ValueError(
                f"checkpoint raster {tuple(raster.shape)} != window "
                f"{self.config.window.shape}"
            )
        self.raster = raster.to(self.device)
        self.t = state["t"]
        self.n_batches = state["n_batches"]
        return self


def default_stream_hook(stream: HeatmapStream, t: float):
    """The default ``on_batch`` of :func:`run_stream`: per-tick
    telemetry (``ingest.metrics.record_stream_tick``), a no-op unless a
    metrics sink is enabled. It does not snapshot the raster, which
    would be a device-to-host copy a tick."""
    from heatmap_tpu_torch.ingest.metrics import record_stream_tick

    record_stream_tick(t)


def run_stream(stream: HeatmapStream, timed_batches, *, on_batch=None):
    """Drive a stream from an iterable of ``(t_seconds, batch)`` pairs,
    where ``batch`` is a columnar point batch (io layout; background
    rows dropped like the batch path, reference heatmap.py:28-29).
    ``on_batch(stream, t)`` fires after each step; the default is
    :func:`default_stream_hook`. The ticks run synchronously through
    ``ingest.run_ticks``."""
    from heatmap_tpu_torch.ingest.loop import run_ticks
    from heatmap_tpu_torch.pipeline.batch import load_columns

    if on_batch is None:
        on_batch = default_stream_hook

    def _tick(item, ctx):
        t, batch = item
        cols = load_columns(batch)
        stream.update(cols["latitude"], cols["longitude"], t)
        on_batch(stream, t)

    run_ticks(timed_batches, _tick)
    return stream


def decayed_oracle(window: Window, timed_points, half_life_s: float):
    """Pure-numpy reference for tests: same decay-then-add semantics.

    ``timed_points``: iterable of (t, lat_array, lon_array).
    """
    raster = np.zeros(window.shape, np.float64)
    last_t = None
    n = 1 << window.zoom
    for t, lat, lon in timed_points:
        dt = 0.0 if last_t is None else t - last_t
        raster *= 2.0 ** (-dt / half_life_s)
        phi = np.asarray(lat, np.float64) * math.pi / 180
        y = (1 - np.log(np.tan(phi) + 1 / np.cos(phi)) / math.pi) / 2
        row = np.floor(y * n) - window.row0
        col = np.floor((np.asarray(lon, np.float64) + 180.0) / 360.0 * n) - window.col0
        ok = (
            np.isfinite(row) & (row >= 0) & (row < window.height)
            & (col >= 0) & (col < window.width)
        )
        np.add.at(raster, (row[ok].astype(np.int64), col[ok].astype(np.int64)), 1.0)
        last_t = t
    return raster
