"""Bucketed padding of the cascade's emissions.

The port's copy of heatmap_tpu/pipeline/bucketing.py. In the JAX package
the cascade is jitted and traced per input shape, so every distinct
emission count (every distinct micro-batch size) compiles afresh; this
module rounds the padded shapes up to a small set of buckets so that
arbitrary batch sizes reuse one compilation per bucket:

- emission arrays are padded to the bucket length with ``valid=False``
  pad lanes, which every cascade kernel drops (the partitioned backend
  gives them the sentinel key, ops/pyramid.py);
- ``n_slots`` is rounded up to a power of two: it feeds only overflow
  checks and the zoom-clamped capacity bound, never slot names, so a
  larger value is byte-neutral;
- the derived default capacity keys off the padded length.

Byte equality with exact padding holds because ``decode_levels``
truncates every level to its real unique count before any host egress.

The port runs its cascade eagerly and compiles nothing per shape, so
here the padding only changes the shapes the card sees (and with them
the segment reduce's input: a tail of sentinel keys). The compile-cache
mirror is kept all the same: ``_run_grouped`` registers the signature
the JAX package's jit would key on, so :func:`cache_stats` (which the
``ingest`` command prints as ``compile_cache``) and the
``cascade_bucket_hits_total`` / ``cascade_bucket_misses_total``
counters equal the JAX package's for the same sequence of batches.

Cost model (docs/ingest.md): pow2 buckets waste < 2x emissions worst
case (amortized ~1.33x); the 1.25x-geometric ladder tightens waste to
< 1.25x at ~3.1x the bucket count.
"""

from __future__ import annotations

import math
import threading


import torch

from heatmap_tpu_torch.obs import get_registry

#: Valid BatchJobConfig.pad_bucketing values. "exact" = no bucketing
#: (the historical behaviour: shapes follow the input exactly).
BUCKETING_MODES = ("exact", "pow2", "geometric")

#: Growth factor of the "geometric" ladder (ROADMAP names 1.25x).
GEOMETRIC_RATIO = 1.25

#: Floor for every bucket: batches below this pad up to it, so the
#: whole small-batch tail shares ONE compilation. 4096 emissions is
#: ~1ms of cascade work on CPU — far below compile cost either way.
DEFAULT_MIN_BUCKET = 1 << 12

_registry = get_registry()

CASCADE_BUCKET_HITS = _registry.counter(
    "cascade_bucket_hits_total",
    "Jitted cascade dispatches that reused a compiled bucket",
    labelnames=("mode",))
CASCADE_BUCKET_MISSES = _registry.counter(
    "cascade_bucket_misses_total",
    "Jitted cascade dispatches that compiled a new bucket signature",
    labelnames=("mode",))
CASCADE_PAD_EMISSIONS = _registry.counter(
    "cascade_pad_emissions_total",
    "Masked pad lanes added by bucketed padding (waste accounting)")

# Signature mirror of the JAX package's jit cache (jax caches per
# (shapes, static args)). Guarded: run_job may be driven from
# producer/consumer threads.
_lock = threading.Lock()
_seen: set = set()
_stats = {"hits": 0, "misses": 0}


def bucket_size(n: int, mode: str,
                min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Bucket length for ``n`` emissions under ``mode``.

    exact -> n unchanged; pow2 -> next power of two >= max(n,
    min_bucket); geometric -> the smallest rung of the
    ``min_bucket * 1.25^k`` ladder >= n. n == 0 stays 0 (an empty
    batch compiles its own trivial shape either way).
    """
    if mode not in BUCKETING_MODES:
        raise ValueError(
            f"unknown pad_bucketing {mode!r} (valid: "
            f"{', '.join(BUCKETING_MODES)})")
    if mode == "exact" or n <= 0:
        return max(int(n), 0)
    n = int(n)
    if n <= min_bucket:
        return int(min_bucket)
    if mode == "pow2":
        return 1 << (n - 1).bit_length()
    # geometric: ceil rung of min_bucket * ratio^k. Computed by log,
    # then corrected for float edge cases so the rung always covers n
    # and the rung index is minimal.
    k = math.ceil(math.log(n / min_bucket) / math.log(GEOMETRIC_RATIO))
    size = int(math.ceil(min_bucket * GEOMETRIC_RATIO ** k))
    while size < n:  # float log undershoot
        k += 1
        size = int(math.ceil(min_bucket * GEOMETRIC_RATIO ** k))
    while k > 0:
        prev = int(math.ceil(min_bucket * GEOMETRIC_RATIO ** (k - 1)))
        if prev < n:
            break
        k, size = k - 1, prev
    return size


def bucket_slots(n_slots: int) -> int:
    """Round the slot count up to a power of two (>= 2).

    ``n_slots`` reaches the cascade only as a static overflow bound and
    the zoom-clamped capacity multiplier — never as data — so a larger
    value cannot change any emitted byte, but a per-batch exact value
    (every new user grows the vocab) would force a recompile per tick.
    """
    n = max(int(n_slots), 2)
    return 1 << (n - 1).bit_length()


def pad_emissions(e_codes, e_slots, e_valid, e_weights, target: int):
    """Pad emission tensors to ``target`` lanes with ``valid=False``, on
    their own device (never through the host). Pad codes/slots are
    zeros (any in-range value works: the valid mask drops them in every
    kernel), pad weights 0.0.
    """
    n = int(e_codes.shape[0])
    pad = target - n
    if pad <= 0:
        return e_codes, e_slots, e_valid, e_weights
    dev = e_codes.device

    def _zeros(like):
        return torch.zeros((pad,), dtype=like.dtype, device=dev)

    e_codes = torch.cat([e_codes, _zeros(e_codes)])
    e_slots = torch.cat([e_slots, _zeros(e_slots)])
    if e_valid is None:
        e_valid = torch.arange(target, device=dev) < n
    else:
        e_valid = torch.cat([e_valid.to(torch.bool),
                             torch.zeros((pad,), dtype=torch.bool,
                                         device=dev)])
    if e_weights is not None:
        e_weights = torch.cat([e_weights, _zeros(e_weights)])
    if _registry.enabled:
        CASCADE_PAD_EMISSIONS.inc(pad)
    return e_codes, e_slots, e_valid, e_weights


def note_dispatch(signature: tuple, mode: str) -> bool:
    """Record one jitted cascade dispatch; True if its compilation
    signature was already seen (a compile-cache hit).

    ``signature`` holds what the JAX package's jit keys its compiled
    cascade on: input shapes and dtypes plus every static arg
    (pipeline.batch builds it next to the run_cascade call).
    """
    with _lock:
        hit = signature in _seen
        if hit:
            _stats["hits"] += 1
        else:
            _seen.add(signature)
            _stats["misses"] += 1
    if _registry.enabled:
        (CASCADE_BUCKET_HITS if hit else CASCADE_BUCKET_MISSES).inc(
            mode=mode)
    return hit


def cache_stats() -> dict:
    """{"hits": n, "misses": n, "signatures": n}: misses are the fresh
    compiles the JAX package's jitted cascade would make (see the
    module docstring)."""
    with _lock:
        return {**_stats, "signatures": len(_seen)}


def reset_cache_stats():
    """Forget seen signatures and counters (tests and benches only;
    after a reset the first dispatch of a signature counts as a miss
    again)."""
    with _lock:
        _seen.clear()
        _stats["hits"] = 0
        _stats["misses"] = 0
