"""Morton-range partition planning (the port's copy of
heatmap_tpu/parallel/partition.py, numpy only).

The planner picks P-1 detail-zoom Morton codes from a sampled quantile
sketch of the input, so each of P shards owns one contiguous Z-order
range. Because the pyramid parent is ``code >> 2`` (order-preserving), a
contiguous detail range rolls up locally at every level: the only keys
two shards can both hold are parent tiles whose children straddle a
split code, at most ``P-1`` per level
(``tilemath.split_boundary_codes_np``).

Skew resistance: after the initial quantile split the planner
iteratively re-splits the heaviest range at its sampled median and
merges the lightest adjacent pair, until no range holds more than
``balance_factor`` times the mean sampled mass (or the heavy range is a
single irreducible code). The result is deterministic for a fixed
sample seed. A plan whose mass still concentrates in one range is
``degenerate``.

The write plane (heatmap_tpu_torch/writeplane) plans its ranges with
:func:`plan_partition` and re-splits a hot range with
:func:`split_range_median`; :func:`route_emissions` is the host-side
scatter into per-shard segments.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from heatmap_tpu_torch import obs
from heatmap_tpu_torch.tilemath.morton import (
    morton_range_shards_np,
    split_boundary_codes_np,
)

#: Sampled sketch size: quantiles over 64Ki points bound the relative
#: rank error near 1/sqrt(sample) — far finer than the balance factor
#: the re-split loop enforces.
DEFAULT_SAMPLE_SIZE = 1 << 16

#: A range may hold at most this multiple of the mean sampled mass
#: before the planner re-splits it. 1.25 keeps the planner's skew gate
#: (max/mean <= 2.0) with margin for sampling noise.
DEFAULT_BALANCE_FACTOR = 1.25

#: A plan is degenerate when one range holds this fraction of the
#: sampled mass after re-splitting: range sharding would serialize the
#: work on one shard.
DEGENERATE_MASS = 0.9


def _range_counts(splits: np.ndarray, samp: np.ndarray) -> np.ndarray:
    """Sampled points per range under ``splits`` (sorted sample)."""
    shards = np.searchsorted(splits, samp, side="right")
    return np.bincount(shards, minlength=len(splits) + 1)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """A Morton-range split of the detail-zoom key space into
    ``n_shards`` contiguous ranges.

    ``splits`` are sorted detail codes; a code belongs to shard
    ``k = #{splits <= code}`` (a split opens the range to its right —
    the single ownership convention shared with the router and the
    kernel). Duplicate splits are legal and denote empty ranges.
    """

    detail_zoom: int
    n_shards: int
    splits: tuple  # (n_shards - 1,) sorted int detail codes
    sampled_points: int
    balance_factor: float
    shard_mass: tuple  # sampled mass fraction per shard
    resplits: int
    fingerprint: str

    @property
    def skew_ratio(self) -> float:
        """Max/mean sampled shard mass; 1.0 is perfectly balanced."""
        if not self.shard_mass or sum(self.shard_mass) <= 0:
            return 1.0
        mean = sum(self.shard_mass) / len(self.shard_mass)
        return max(self.shard_mass) / mean

    @property
    def degenerate(self) -> bool:
        """True when range sharding would serialize on one shard."""
        if self.n_shards < 2 or self.sampled_points == 0:
            return True
        nonempty = sum(1 for m in self.shard_mass if m > 0)
        return nonempty < 2 or max(self.shard_mass) >= DEGENERATE_MASS

    def shard_of_codes(self, codes) -> np.ndarray:
        """Owning shard index per detail code (int32)."""
        return morton_range_shards_np(np.asarray(self.splits, np.int64),
                                      codes)

    def boundary_codes(self, levels: int) -> np.ndarray:
        """Parent codes ``levels`` above detail straddling a split."""
        return split_boundary_codes_np(
            np.asarray(self.splits, np.int64), levels)

    def boundary_tiles_total(self, n_levels: int) -> int:
        """Straddling tiles summed over coarse levels 1..n_levels —
        the entire per-pyramid cross-shard merge key set."""
        return sum(len(self.boundary_codes(lvl))
                   for lvl in range(1, n_levels + 1))

    def code_ranges(self) -> list:
        """Per-shard ``[lo, hi)`` detail-code ranges covering the full
        ``[0, 4^detail_zoom)`` key space."""
        total = 1 << (2 * self.detail_zoom)
        edges = [0, *[int(s) for s in self.splits], total]
        return [(edges[k], edges[k + 1]) for k in range(self.n_shards)]


def plan_partition(codes, n_shards: int, *, detail_zoom: int, valid=None,
                   sample_size: int = DEFAULT_SAMPLE_SIZE, seed: int = 0,
                   balance_factor: float = DEFAULT_BALANCE_FACTOR,
                   max_resplits=None, n_levels=None) -> PartitionPlan:
    """Plan ``n_shards`` contiguous Morton ranges from sampled codes.

    Deterministic for fixed ``(codes, n_shards, seed)``. ``valid``
    masks lanes whose codes are garbage (out-of-projection points);
    they carry no mass. ``n_levels``, when given, sizes the
    boundary-tile count folded into the planned-event metrics.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    codes = np.asarray(codes, np.int64)
    if valid is not None:
        codes = codes[np.asarray(valid, bool)]
    rng = np.random.default_rng(seed)
    if len(codes) > sample_size:
        samp = codes[rng.choice(len(codes), size=sample_size,
                                replace=False)]
    else:
        samp = codes
    samp = np.sort(samp)
    m = len(samp)
    P = int(n_shards)

    resplits = 0
    if m == 0 or P == 1:
        # Nothing to learn from: geometric even split of the key space
        # (callers treat the zero-sample plan as degenerate anyway).
        total = 1 << (2 * detail_zoom)
        splits = np.asarray(
            [(i + 1) * total // P for i in range(P - 1)], np.int64)
    else:
        splits = samp[np.minimum(
            np.arange(1, P) * m // P, m - 1)].astype(np.int64)
        if max_resplits is None:
            max_resplits = 4 * P
        for _ in range(int(max_resplits)):
            c = _range_counts(splits, samp)
            worst = int(np.argmax(c))
            if c[worst] <= balance_factor * (m / P):
                break
            starts = np.concatenate(([0], np.cumsum(c)))
            sl = samp[starts[worst]:starts[worst + 1]]
            med = sl[len(sl) // 2]
            if med == sl[0]:
                # Median collides with the range's smallest code; the
                # first strictly-greater sample still moves mass left.
                gt = int(np.searchsorted(sl, sl[0], side="right"))
                if gt >= len(sl):
                    break  # single-code hotspot: irreducible
                med = sl[gt]
            cand = np.sort(np.append(splits, med))
            jm = int(np.searchsorted(cand, med))
            c2 = _range_counts(cand, samp)
            # Fund the new split by merging the lightest adjacent pair
            # (never the pair the new split just created).
            pair = c2[:-1] + c2[1:]
            pair[jm] = np.iinfo(pair.dtype).max if pair.dtype.kind in "iu" \
                else np.inf
            best_j = int(np.argmin(pair))
            if best_j == jm:
                break
            splits = np.delete(cand, best_j)
            resplits += 1

    mass = (_range_counts(splits, samp) / m if m else
            np.zeros(P, np.float64))
    payload = {"detail_zoom": int(detail_zoom), "n_shards": P,
               "splits": [int(s) for s in splits], "seed": int(seed),
               "balance_factor": float(balance_factor),
               "sampled_points": int(m)}
    fp = hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()
    plan = PartitionPlan(
        detail_zoom=int(detail_zoom), n_shards=P,
        splits=tuple(int(s) for s in splits), sampled_points=int(m),
        balance_factor=float(balance_factor),
        shard_mass=tuple(float(x) for x in mass), resplits=resplits,
        fingerprint=fp)
    obs.record_partition_planned(
        plan,
        boundary_tiles=(plan.boundary_tiles_total(n_levels)
                        if n_levels is not None else None))
    return plan


def split_range_median(codes, weights, lo: int, hi: int):
    """Weighted-median split code for one hot Morton range ``[lo, hi)``.

    The write plane's rebalance uses the same move the re-split loop
    above makes — cut the heavy range at its mass median — but against
    the range's *materialized* cell codes/weights (the compacted base's
    detail rows) instead of a point sample. Returns an int split code
    ``s`` with ``lo < s < hi`` such that roughly half the in-range mass
    lands in ``[lo, s)``, or ``None`` when the range is irreducible
    (empty, or all mass on its smallest code).
    """
    codes = np.asarray(codes, np.int64)
    weights = np.asarray(weights, np.float64)
    keep = (codes >= lo) & (codes < hi) & (weights > 0)
    codes, weights = codes[keep], weights[keep]
    if len(codes) == 0:
        return None
    order = np.argsort(codes, kind="stable")
    codes, weights = codes[order], weights[order]
    cum = np.cumsum(weights)
    idx = int(np.searchsorted(cum, cum[-1] / 2.0, side="left"))
    med = int(codes[min(idx, len(codes) - 1)])
    if med <= lo:
        # All of the left half sits on the smallest code; the first
        # strictly-greater code still moves mass left (same escape the
        # planner's re-split loop takes).
        gt = int(np.searchsorted(codes, med, side="right"))
        if gt >= len(codes):
            return None  # single-code hotspot: irreducible
        med = int(codes[gt])
    if not (lo < med < hi):
        return None
    return med


def route_emissions(plan: PartitionPlan, codes, slots, valid=None,
                    weights=None, bucket=None):
    """Scatter emission lanes into per-shard contiguous segments.

    Returns ``(codes, slots, valid, weights, seg_len)`` where each
    array is ``(n_shards * seg_len,)`` and shard ``k``'s lanes occupy
    ``[k*seg_len, (k+1)*seg_len)``; pad lanes are ``valid=False`` —
    the masking path every cascade kernel already drops. Invalid input
    lanes are dropped here (they carry garbage codes that would skew a
    shard's segment for no output). ``bucket`` maps the raw max shard
    count to a padded segment length so per-range shapes hit the
    bucketed compile cache.
    """
    codes = np.asarray(codes, np.int64)
    slots = np.asarray(slots)
    v_mask = (np.ones(len(codes), bool) if valid is None
              else np.asarray(valid, bool))
    w = None if weights is None else np.asarray(weights)
    P = plan.n_shards

    src = np.flatnonzero(v_mask)
    sid = plan.shard_of_codes(codes[src])
    order = np.argsort(sid, kind="stable")
    src, sid = src[order], sid[order]
    counts = np.bincount(sid, minlength=P)
    seg = max(int(counts.max()) if len(counts) else 0, 1)
    if bucket is not None:
        seg = max(int(bucket(seg)), seg)
    starts = np.concatenate(([0], np.cumsum(counts)))
    dst = sid * seg + (np.arange(len(src)) - starts[sid])

    out_codes = np.zeros(P * seg, codes.dtype)
    out_slots = np.zeros(P * seg, slots.dtype)
    out_valid = np.zeros(P * seg, bool)
    out_codes[dst] = codes[src]
    out_slots[dst] = slots[src]
    out_valid[dst] = True
    out_w = None
    if w is not None:
        out_w = np.zeros(P * seg, w.dtype)
        out_w[dst] = w[src]
    return out_codes, out_slots, out_valid, out_w, seg
