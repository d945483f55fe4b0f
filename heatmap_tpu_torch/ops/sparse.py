"""Fixed-capacity sparse aggregation: sort + segment-sum over integer keys.

Port of heatmap_tpu/ops/sparse.py, the cascade's "scatter" backend.
:func:`aggregate_sorted_keys` is also the plain PyTorch version of the
CUDA segment reduce (ops/sparse_partitioned.py), which the CPU runs and
the chip check holds the kernel against.

torch's ``index_add_``/``scatter_`` have no ``mode="drop"``: dropped
lanes are written to slot ``capacity`` of a ``capacity + 1`` buffer,
which is then sliced off. No out-of-range index ever reaches a
scatter (on CUDA that is a device assert, not a drop).
"""

from __future__ import annotations

import torch

from heatmap_tpu_torch.devices import stage


def _sentinel_for(dtype):
    return torch.iinfo(dtype).max


def aggregate_keys(keys, weights=None, valid=None, capacity=None,
                   acc_dtype=None, timer=None):
    """Reduce-by-key: sum ``weights`` per unique key.

    Args:
      keys: int tensor [N]. The dtype's maximum is the internal sentinel,
        so a key equal to it is dropped.
      weights: [N] or None (None counts occurrences in int32).
      valid: optional bool [N]; invalid lanes are excluded entirely.
      capacity: max distinct keys to emit (default N).
      acc_dtype: accumulator dtype (int32 for counts, float32 for
        weights, as in the JAX package; weighted jobs pass float64).
      timer: optional devices.StageTimer ("sort", "segment_reduce").

    Returns ``(unique_keys[capacity], sums[capacity], n_unique)``: slots
    past n_unique hold the sentinel key and a zero sum, unique keys are
    sorted ascending, and ``n_unique`` (an int32 tensor) is the TRUE
    distinct-key count, which exceeds ``capacity`` on overflow.
    """
    n = keys.shape[0]
    capacity = n if capacity is None else capacity
    if acc_dtype is None:
        acc_dtype = torch.int32 if weights is None else torch.float32
    w = (
        torch.ones(n, dtype=acc_dtype, device=keys.device)
        if weights is None
        else torch.as_tensor(weights).to(acc_dtype)
    )
    sentinel = _sentinel_for(keys.dtype)
    if valid is not None:
        keys = torch.where(valid, keys, sentinel)
        w = torch.where(valid, w, 0)

    # Counts are exact in any summation order, so their sort may be
    # unstable; weights keep the stable order so sums reproduce the
    # host-order reference bit-for-bit.
    with stage(timer, "sort"):
        sk, order = torch.sort(keys, stable=weights is not None)
        sw = w[order]
    with stage(timer, "segment_reduce"):
        return aggregate_sorted_keys(sk, sw, capacity, sentinel=sentinel)


def aggregate_sorted_keys(sorted_keys, sorted_weights, capacity: int,
                          sentinel=None):
    """Segment-sum already-sorted keys (see :func:`aggregate_keys`).

    Separate because the Morton pyramid re-aggregates the same sorted
    order at every level.
    """
    if sentinel is None:
        sentinel = _sentinel_for(sorted_keys.dtype)
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    is_real = sorted_keys != sentinel
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    # Sentinel lanes (masked-out points) must not open a segment.
    first &= is_real
    seg = torch.cumsum(first, 0, dtype=torch.int64) - 1
    # Dropped lanes (sentinel, or past capacity) go to slot `capacity`.
    idx = torch.where(is_real, seg, capacity).clamp_(max=capacity)

    sums = torch.zeros(capacity + 1, dtype=sorted_weights.dtype, device=dev)
    sums.index_add_(0, idx, sorted_weights)
    unique = torch.full((capacity + 1,), sentinel, dtype=sorted_keys.dtype,
                        device=dev)
    unique.scatter_(0, idx, sorted_keys)
    n_unique = first.sum(dtype=torch.int32)
    return unique[:capacity], sums[:capacity], n_unique
