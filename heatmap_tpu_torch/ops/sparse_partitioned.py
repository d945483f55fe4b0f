"""The cascade's per-level segment reduce on a hand-written CUDA kernel.

Port of heatmap_tpu/ops/sparse_partitioned.py. The TPU kernel
(``_segment_kernel``) rebuilds each segment's count and key through
one-hot MXU matmuls over 20-bit f32 channels, in slabs that keep f32
sums exact, with an f64 scatter tail and a full-scatter fallback. On
Hopper none of that is needed: ``csrc/segment_reduce.cu`` is one
single-pass int64 scan-and-reduce (a decoupled look-back over tiles of
:data:`TILE_KEYS` keys), exact by construction: counts are written once
per segment without atomics, and bounded-integer weights go through
order-free integer atomics, so results are byte-identical run to run
and identical to the plain version.

:func:`aggregate_sorted_keys_partitioned` keeps the JAX function's
output contract and refusals. A CUDA tensor launches the kernel; a CPU
tensor takes the plain PyTorch version (ops.sparse.aggregate_sorted_keys
plus the weight-contract check). Nothing falls back from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from heatmap_tpu_torch import _build
from heatmap_tpu_torch.ops.sparse import aggregate_sorted_keys

#: The TPU kernel's chunk; the weighted refusal below keeps its geometry
#: so the port refuses exactly the bounds the JAX package refuses.
DEFAULT_CHUNK = 1024

#: Keys per tile of csrc/segment_reduce.cu (256 threads x 8 keys). The
#: kernel's entry points refuse any other value, so the planning here
#: cannot drift from the kernel.
TILE_KEYS = 2048

_INT32_MAX = (1 << 31) - 1
_P, _I, _I64, _F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double)
#: (function, argtypes) of csrc/segment_reduce.cu's C interface. Every
#: pointer and the stream are c_void_p: a plain int would be cut to 32
#: bits.
_SIGNATURES = (
    # keys, n, shift, sentinel, capacity, tile_keys, status, unique,
    # counts, n_unique, stream
    ("hm_segment_reduce_counts",
     (_P, _I64, _I, _I64, _I64, _I, _P, _P, _P, _P, _P)),
    # keys, weights, n, shift, sentinel, capacity, weight_bound,
    # tile_keys, status, unique, sums, bad, n_unique, stream
    ("hm_segment_reduce_weighted",
     (_P, _P, _I64, _I, _I64, _I64, _F64, _I, _P, _P, _P, _P, _P, _P)),
)


def status_words(n: int) -> int:
    """int64 words of the kernel's zeroed scratch for ``n`` keys: the
    tile counter, then one look-back status word per tile."""
    return 1 + -(-n // TILE_KEYS)


def _check_weight_bound(weight_bound):
    """The JAX package's weighted refusals at its default geometry (one
    stream of DEFAULT_CHUNK lanes), worded as it words them
    (heatmap_tpu/ops/sparse_partitioned.py:320-343)."""
    if weight_bound is None or weight_bound < 1:
        raise ValueError(
            "weighted partitioned reduction needs a positive "
            "static weight_bound (exactness slab = 2^24 // bound)"
        )
    unit = DEFAULT_CHUNK
    exact_slab = ((1 << 24) // weight_bound) // unit * unit
    if exact_slab < unit:
        raise ValueError(
            f"weight_bound {weight_bound} is too large for the "
            f"exactness slab: 2^24 // bound = "
            f"{(1 << 24) // weight_bound} elements, below one "
            f"chunk row per stream (streams*chunk = {unit}) — "
            f"shrink chunk/streams or the bound (max bound at "
            f"this geometry: {(1 << 24) // unit}), or use the "
            "scatter backend"
        )


def _check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {rc}")


def aggregate_sorted_keys_partitioned(sorted_keys, capacity: int,
                                      sentinel=None, shift: int = 0,
                                      sorted_weights=None,
                                      weight_bound: int | None = None):
    """Segment-reduce sorted int64 keys read as ``sorted_keys >> shift``.

    Returns ``(unique int64[capacity], sums[capacity], n_unique)``, the
    contract of ops.sparse.aggregate_sorted_keys on the shifted keys:
    slots past ``n_unique`` hold ``sentinel`` and zero, and ``n_unique``
    (an int32 tensor on the keys' device) exceeds ``capacity`` on
    overflow. ``sentinel`` is compared with the SHIFTED keys (default
    int64 max). ``shift`` lets every cascade level read the one sorted
    array without materialising ``keys >> 2*level``.

    Counts (``sorted_weights=None``) come back as int32. With
    ``sorted_weights`` (float64, same order as the keys) the sums are
    float64 per-key totals, exact PROVIDED every weight is an integer in
    ``[0, weight_bound]`` (required). A weight that breaks the contract
    (fractional, negative, above the bound, NaN) is detected on the
    device and sets ``n_unique`` to at least ``capacity + 1``, the
    repo-wide overflow signal, so a wrong sum is never silent.

    ``aggregate_sorted_keys_partitioned.launches`` counts the calls
    that launched the CUDA kernel.
    """
    if sorted_keys.dtype != torch.int64:
        raise TypeError(f"sorted_keys must be int64, got {sorted_keys.dtype}")
    if sorted_keys.dim() != 1 or not sorted_keys.is_contiguous():
        raise ValueError("sorted_keys must be a contiguous 1-D tensor")
    if not 0 <= capacity < _INT32_MAX:
        raise ValueError(
            f"capacity {capacity} must be in [0, 2^31 - 1) (int32 slots)")
    if not 0 <= shift < 63:
        raise ValueError(f"shift must be in [0, 63), got {shift}")
    n = sorted_keys.shape[0]
    if n > _INT32_MAX:
        raise ValueError(f"{n} keys exceed the int32 segment ids")
    if sentinel is None:
        sentinel = torch.iinfo(torch.int64).max
    weighted = sorted_weights is not None
    if weighted:
        _check_weight_bound(weight_bound)
        if sorted_weights.dtype != torch.float64:
            raise TypeError(
                f"sorted_weights must be float64, got {sorted_weights.dtype}")
        if (sorted_weights.shape != sorted_keys.shape
                or not sorted_weights.is_contiguous()
                or sorted_weights.device != sorted_keys.device):
            raise ValueError(
                "sorted_weights must be contiguous, of the keys' shape, "
                "on the keys' device")
    dev = sorted_keys.device
    if dev.type == "cpu":
        return _plain(sorted_keys, capacity, int(sentinel), shift,
                      sorted_weights, weight_bound)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with torch.cuda.device(dev):
        return _launch(sorted_keys, capacity, int(sentinel), shift,
                       sorted_weights, weight_bound)


aggregate_sorted_keys_partitioned.launches = 0


def _plain(keys, capacity, sentinel, shift, weights, weight_bound):
    """The plain PyTorch version: the scatter reduce on the shifted keys,
    plus the weight-contract poison of the JAX kernel. Like the kernel,
    it sums a weight that breaks the contract as 0 (the poisoned
    ``n_unique`` already marks those sums as unusable)."""
    keys = keys >> shift
    if weights is None:
        w = torch.ones(keys.shape[0], dtype=torch.int32, device=keys.device)
        return aggregate_sorted_keys(keys, w, capacity, sentinel=sentinel)
    is_real = keys != sentinel
    # NaN fails the first test, as in the kernel.
    ok = (weights == torch.floor(weights)) & (weights >= 0) & (
        weights <= weight_bound)
    bad = ~ok & is_real
    unique, sums, n_unique = aggregate_sorted_keys(
        keys, torch.where(is_real & ok, weights, 0.0), capacity,
        sentinel=sentinel)
    n_unique = torch.where(
        bad.any(), torch.clamp(n_unique, min=capacity + 1), n_unique)
    return unique, sums, n_unique


def _launch(keys, capacity, sentinel, shift, weights, weight_bound):
    """The CUDA path: one scan-and-reduce launch (and its padding
    epilogue) into outputs that the kernel writes whole."""
    lib = _build.load("segment_reduce", _SIGNATURES)
    dev = keys.device
    n = keys.shape[0]
    if n == 0:
        unique = torch.full((capacity,), sentinel, dtype=torch.int64,
                            device=dev)
        n_unique = torch.zeros((), dtype=torch.int32, device=dev)
        sums = torch.zeros(capacity, device=dev,
                           dtype=torch.int32 if weights is None
                           else torch.float64)
        return unique, sums, n_unique
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = torch.zeros(status_words(n), dtype=torch.int64, device=dev)
    unique = torch.empty(capacity, dtype=torch.int64, device=dev)
    n_unique = torch.empty((), dtype=torch.int32, device=dev)
    if weights is None:
        counts = torch.empty(capacity, dtype=torch.int32, device=dev)
        _check_launch(lib.hm_segment_reduce_counts(
            keys.data_ptr(), n, shift, sentinel, capacity, TILE_KEYS,
            status.data_ptr(), unique.data_ptr(), counts.data_ptr(),
            n_unique.data_ptr(), stream), "hm_segment_reduce_counts")
        _build.count_launch(aggregate_sorted_keys_partitioned)
        return unique, counts, n_unique
    wsums = torch.zeros(capacity, dtype=torch.int64, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    _check_launch(lib.hm_segment_reduce_weighted(
        keys.data_ptr(), weights.data_ptr(), n, shift, sentinel, capacity,
        float(weight_bound), TILE_KEYS, status.data_ptr(), unique.data_ptr(),
        wsums.data_ptr(), bad.data_ptr(), n_unique.data_ptr(), stream),
        "hm_segment_reduce_weighted")
    _build.count_launch(aggregate_sorted_keys_partitioned)
    # Integer sums stay below 2^53, so the float64 cast is exact.
    sums = wsums.to(torch.float64)
    n_unique = torch.where(
        bad[0] != 0, torch.clamp(n_unique, min=capacity + 1), n_unique)
    return unique, sums, n_unique
