"""The zoom cascade: one sorted composite key, sixteen levels.

Port of the single-device cascade of heatmap_tpu/pipeline/cascade.py.
The whole cascade is one device-side sparse pyramid over composite
integer keys

    key = slot * 4^detail_zoom + morton_code,  slot = timespan*G + group

Because the slot multiplier is a power of four, ``key >> 2`` coarsens
the Morton part one zoom, leaves the (timespan, group) slot intact and
preserves sort order, so every level is a segment reduce over the order
of a single sort (ops/pyramid.py). Blob regrouping happens on the host
at egress: the blob id is ``key >> 2*result_delta``.

``amplify_all=True`` reproduces the reference's 'all'-amplification
quirk (``all_z = 2*all_{z+1} + sum_users user_{z+1}``) as a host-side
post-pass over the correct per-level aggregates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from heatmap_tpu_torch import native
from heatmap_tpu_torch.ops import pyramid as pyramid_ops
from heatmap_tpu_torch.tilemath.morton import morton_decode_np


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Static cascade parameters (reference heatmap.py:16-17).

    Levels run at detail zooms ``detail_zoom`` down to
    ``min_detail_zoom + 1`` inclusive (z21..z6 by default); each level's
    blobs are keyed by the tile ``result_delta`` zooms coarser.
    """

    detail_zoom: int = 21
    min_detail_zoom: int = 5
    result_delta: int = 5
    amplify_all: bool = False

    @property
    def n_levels(self) -> int:
        return self.detail_zoom - self.min_detail_zoom - 1

    def __post_init__(self):
        if self.min_detail_zoom + 1 > self.detail_zoom:
            raise ValueError(f"empty cascade: {self}")
        if self.detail_zoom - self.n_levels - self.result_delta < 0:
            raise ValueError(
                f"result tiles would go below zoom 0: {self} "
                f"(min detail zoom {self.min_detail_zoom + 1} needs "
                f"result_delta <= {self.min_detail_zoom + 1})"
            )


def _slot_bits(n_slots: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n_slots, 2)))))


def composite_keys(codes, slots, detail_zoom: int, n_slots: int):
    """Pack (slot, morton_code) into one sortable, shiftable int64 key."""
    code_bits = 2 * detail_zoom
    if code_bits + _slot_bits(n_slots) >= 63:
        raise ValueError(
            f"composite keys overflow int64: zoom {detail_zoom} with {n_slots} slots"
        )
    return (slots.to(torch.int64) << code_bits) | codes.to(torch.int64)


def decode_level_keys(level_keys: np.ndarray, detail_zoom: int, level: int):
    """Host-side inverse at pyramid ``level``: -> (slot, morton_code)."""
    code_bits = 2 * (detail_zoom - level)
    k = np.asarray(level_keys, np.int64)
    return k >> code_bits, k & ((1 << code_bits) - 1)


def build_cascade(codes, slots, config: CascadeConfig, n_slots: int,
                  weights=None, valid=None, capacity=None, acc_dtype=None,
                  backend: str = "scatter", weight_bound: int | None = None,
                  timer=None, adaptive: bool = False):
    """Device-side cascade: per-level (composite key, sum, n_unique).

    ``backend`` is "scatter" (ops.sparse.aggregate_sorted_keys per level)
    or "partitioned" (the CUDA segment-reduce kernel reading every level
    from one sort; count jobs, or weighted jobs under the bounded-integer
    ``weight_bound`` contract). The tensors stay on their device; the
    cascade runs eagerly. ``adaptive`` (BatchJobConfig.adaptive_capacity)
    shrinks levels 1.. to the real unique counts on either backend, one
    host sync per level (ops/pyramid.py); results are identical.
    """
    if backend == "partitioned":
        # Refusal parity with the JAX package: its kernel rebuilds keys
        # from three 20-bit channels, so it takes keys of <= 60 bits.
        slot_bits = _slot_bits(n_slots)
        if 2 * config.detail_zoom + slot_bits > 60:
            raise ValueError(
                f"cascade backend 'partitioned' reconstructs keys from "
                f"three 20-bit channels (60-bit limit); zoom "
                f"{config.detail_zoom} with {n_slots} slots needs "
                f"{2 * config.detail_zoom + slot_bits} bits — use the "
                "scatter backend"
            )
        if weights is not None and weight_bound is None:
            raise ValueError(
                "cascade backend 'partitioned' takes weighted jobs "
                "only under the bounded-integer contract (weights "
                "integer in [0, weight_bound]; exactness slab = "
                "2^24 // bound — ops/sparse_partitioned.py): pass "
                "weight_bound, or use the scatter backend (required "
                "for fractional weights)"
            )
    elif backend != "scatter":
        raise ValueError(f"unknown cascade backend {backend!r}")
    ck = composite_keys(codes, slots, config.detail_zoom, n_slots)
    # Zoom-clamped per-level capacities: level l's key space holds at
    # most n_slots * 4^(detail_zoom - l) keys, so coarse levels get small
    # arrays instead of n-sized padding.
    if capacity is None or isinstance(capacity, int):
        base = capacity or max(int(codes.shape[0]), 1)
        capacity = [
            min(base, n_slots << (2 * (config.detail_zoom - lvl)))
            for lvl in range(config.n_levels + 1)
        ]
    if backend == "partitioned":
        return pyramid_ops.pyramid_sparse_morton_partitioned(
            ck, valid=valid, levels=config.n_levels, capacity=capacity,
            weights=weights,
            weight_bound=weight_bound if weights is not None else None,
            timer=timer, adaptive=adaptive,
        )
    return pyramid_ops.pyramid_sparse_morton(
        ck, weights=weights, valid=valid, levels=config.n_levels,
        capacity=capacity, acc_dtype=acc_dtype, timer=timer,
        adaptive=adaptive,
    )


#: The production cascade entry. PyTorch runs eagerly, so there is no
#: jitted twin to route between.
run_cascade = build_cascade


def decode_levels(level_data, config: CascadeConfig):
    """One decode pass shared by all egress consumers.

    Returns per-level dicts of numpy arrays
    ``{slot, code, row, col, zoom, value}`` with float64 values (the
    reference emits float counts). Raises on capacity overflow. The
    per-level counts cross to the host in one transfer, and each level
    is cut to its real rows on its device before it crosses. The keys
    are split and Morton-decoded by the native library where it loads
    (int32 slots), by numpy otherwise.
    """
    n_lvls = config.n_levels + 1
    counts = torch.stack(
        [level_data[lvl][2] for lvl in range(n_lvls)]).cpu().tolist()
    for level, n in enumerate(counts):
        if n > level_data[level][0].shape[0]:
            raise ValueError(
                f"cascade level {level} overflowed capacity "
                f"({n} uniques > {level_data[level][0].shape[0]}); "
                f"raise `capacity`"
            )
    # Every level's real rows cross in one transfer per column.
    keys_host = torch.cat(
        [level_data[lvl][0][:n] for lvl, n in enumerate(counts)]).cpu().numpy()
    sums_host = torch.cat(
        [level_data[lvl][1][:n] for lvl, n in enumerate(counts)]).cpu().numpy()
    bounds = np.cumsum([0] + counts)
    use_native = native.available()
    out = []
    for level in range(n_lvls):
        keys_arr = keys_host[bounds[level]:bounds[level + 1]]
        sums = sums_host[bounds[level]:bounds[level + 1]]
        code_bits = 2 * (config.detail_zoom - level)
        # The native decoder returns int32 slots. Slot ids are
        # key >> code_bits: with code_bits >= 33 they fit int32 by
        # construction; below that the level's largest key decides.
        if use_native and (code_bits >= 33 or keys_arr.size == 0
                           or int(keys_arr.max()) >> code_bits < 2**31):
            slot_ids, codes, rows, cols = native.decode_keys(keys_arr,
                                                             code_bits)
        else:
            slot_ids, codes = decode_level_keys(keys_arr, config.detail_zoom,
                                                level)
            rows, cols = morton_decode_np(codes)
        out.append(
            {
                "zoom": config.detail_zoom - level,
                "slot": slot_ids,
                "code": codes,
                "row": rows,
                "col": cols,
                "value": sums.astype(np.float64),
            }
        )
    return out


def finalize_level_arrays(levels, config: CascadeConfig, slot_names):
    """Resolve slot names, add coarse (blob) tile coordinates and apply
    the amplify_all compat patch.

    User and timespan columns are dictionary-encoded: per-row int32
    ``user_idx``/``timespan_idx`` into the small ``user_names``/
    ``timespan_names`` tables.
    """
    if config.amplify_all:
        _patch_amplified(levels, slot_names)
    n_slots = max(slot_names) + 1
    users = np.array([slot_names.get(s, ("?", "?"))[0] for s in range(n_slots)])
    tss = np.array([slot_names.get(s, ("?", "?"))[1] for s in range(n_slots)])
    user_names, slot_to_uidx = np.unique(users, return_inverse=True)
    ts_names, slot_to_tidx = np.unique(tss, return_inverse=True)
    slot_to_uidx = slot_to_uidx.astype(np.int32)
    slot_to_tidx = slot_to_tidx.astype(np.int32)
    for lvl in levels:
        lvl["user_idx"] = slot_to_uidx[lvl["slot"]]
        lvl["timespan_idx"] = slot_to_tidx[lvl["slot"]]
        lvl["user_names"] = user_names
        lvl["timespan_names"] = ts_names
        lvl["coarse_zoom"] = lvl["zoom"] - config.result_delta
        lvl["coarse_row"] = lvl["row"] >> config.result_delta
        lvl["coarse_col"] = lvl["col"] >> config.result_delta
    return levels


def level_strings(lvl, sel=None):
    """(user, timespan) string arrays for a finalized level: full
    columns, or only rows ``sel``."""
    ui, ti = lvl["user_idx"], lvl["timespan_idx"]
    if sel is not None:
        ui, ti = ui[sel], ti[sel]
    return lvl["user_names"][ui], lvl["timespan_names"][ti]


def emit_blobs(level_data, config: CascadeConfig, slot_names):
    """Reference-format blobs
    ``{"user|timespan|coarseTileId": {detailTileId: float count}}``
    (reference heatmap.py:54-55,79-90,128-129)."""
    return blobs_from_level_arrays(
        finalize_level_arrays(decode_levels(level_data, config), config,
                              slot_names))


def blobs_from_level_arrays(levels):
    """Reference-format blobs from finalized level arrays."""
    sep = "|"  # reference KEY_SEPERATOR [sic], heatmap.py:18
    blobs: dict[str, dict[str, float]] = {}
    for lvl in levels:
        if len(lvl["slot"]) == 0:
            continue
        users, tss = level_strings(lvl)
        blob_ids = np.char.add(
            np.char.add(users, sep + tss + sep),
            _tile_id_strings(lvl["coarse_zoom"], lvl["coarse_row"],
                             lvl["coarse_col"]),
        )
        detail_ids = _tile_id_strings(lvl["zoom"], lvl["row"], lvl["col"])
        values = lvl["value"]
        order = np.argsort(blob_ids, kind="stable")
        sorted_ids = blob_ids[order]
        starts = np.flatnonzero(
            np.concatenate([[True], sorted_ids[1:] != sorted_ids[:-1]])
        )
        bounds = np.append(starts, len(sorted_ids))
        for k, s in enumerate(starts):
            idx = order[s:bounds[k + 1]]
            blobs.setdefault(str(sorted_ids[s]), {}).update(
                zip(detail_ids[idx].tolist(), values[idx].tolist())
            )
    return blobs


def json_blobs_from_level_arrays(levels):
    """``{blob_id: json_string}`` egress without per-aggregate Python.

    Equal to ``{k: json.dumps(v) for k, v in
    blobs_from_level_arrays(levels).items()}``: numpy's shortest
    round-trip float repr matches ``json.dumps`` for doubles, and entry
    order within a blob is kept. Level arrays arrive sorted by
    (slot, code), so blob runs are contiguous and blob-id strings are
    built only at run starts, by the native formatter where the library
    loads and by numpy otherwise.
    """
    sep = "|"
    out: dict[str, str] = {}
    for lvl in levels:
        if len(lvl["slot"]) == 0:
            continue
        slots = lvl["slot"]
        is_start = np.concatenate([[True], (
            (slots[1:] != slots[:-1])
            | (lvl["coarse_row"][1:] != lvl["coarse_row"][:-1])
            | (lvl["coarse_col"][1:] != lvl["coarse_col"][:-1])
        )])
        sidx = np.flatnonzero(is_start)
        if native.available():
            ids = native.format_blob_ids(
                lvl["user_idx"][sidx], lvl["timespan_idx"][sidx],
                lvl["coarse_row"][sidx], lvl["coarse_col"][sidx],
                int(lvl["coarse_zoom"]), lvl["user_names"],
                lvl["timespan_names"])
        else:
            users, tss = level_strings(lvl, sidx)
            ids = np.char.add(
                np.char.add(users, sep + tss + sep),
                _tile_id_strings(lvl["coarse_zoom"], lvl["coarse_row"][sidx],
                                 lvl["coarse_col"][sidx]),
            ).tolist()
        out.update(zip(ids, _blob_bodies(lvl, is_start)))
    return out


def _blob_bodies(lvl, is_start):
    """Per-blob '{...}' JSON documents for one level, in order.

    The native formatter takes integral values below 1e15 (every count
    job, and weighted jobs whose sums are whole); the numpy join/split
    below formats fractional sums and is the formatting oracle.
    """
    values = lvl["value"]
    if native.available() and bool(
            np.all((values == np.floor(values)) & (np.abs(values) < 1e15))):
        return native.format_blob_bodies(lvl["row"], lvl["col"], values,
                                         is_start, int(lvl["zoom"]))
    frag = np.char.add(
        np.char.add(
            np.char.add(
                '"', _tile_id_strings(lvl["zoom"], lvl["row"], lvl["col"])
            ),
            '": ',
        ),
        values.astype(str),
    )
    # Run starts open a new document ('}\x00{' closes the previous one);
    # the rest continue with ', '. One join, one split.
    parts = np.char.add(np.where(is_start, "}\x00{", ", "), frag)
    big = "".join(parts.tolist()) + "}"
    return big.split("\x00")[1:]  # [0] is the artifact '}' head


def _tile_id_strings(zoom, rows, cols):
    """Vectorized reference tile-id strings "zoom_row_col"."""
    z = np.char.add(np.asarray(zoom).astype(str), "_")
    return np.char.add(
        np.char.add(np.char.add(z, rows.astype(str)), "_"), cols.astype(str)
    )


def _sorted_lookup(sorted_keys, sorted_vals, queries):
    """Value per query from a sorted (keys, vals) table; 0.0 on miss."""
    if len(sorted_keys) == 0 or len(queries) == 0:
        return np.zeros(len(queries), np.float64)
    pos = np.clip(np.searchsorted(sorted_keys, queries), 0,
                  len(sorted_keys) - 1)
    return np.where(sorted_keys[pos] == queries, sorted_vals[pos], 0.0)


def _patch_amplified(levels, slot_names):
    """In-place 'all' amplification (SURVEY.md §8.1 recurrence):

    A_0 = all_0 (correct);  A_L = 2 * rollup(A_{L-1}) + sum_users user_L.
    Per-user counts are untouched, as in the reference. Every step works
    on packed ``(slot << code_bits) | code`` int64 keys (sorted, since
    level arrays arrive in ascending composite-key order).
    """
    is_all_slot = np.array(
        [slot_names.get(s, ("?",))[0] == "all" for s in range(max(slot_names) + 1)]
    )
    prev_s = prev_c = np.empty(0, np.int64)
    prev_v = np.empty(0, np.float64)
    for level, lvl in enumerate(levels):
        slots = np.asarray(lvl["slot"], np.int64)
        codes = np.asarray(lvl["code"], np.int64)
        vals = np.asarray(lvl["value"], np.float64)
        cb = 2 * lvl["zoom"]  # codes at this level are < 4**zoom
        all_mask = (
            is_all_slot[slots] if len(slots) else np.zeros(0, bool)
        )
        a_s, a_c = slots[all_mask], codes[all_mask]
        if level == 0:
            new_all = vals[all_mask]
        else:
            # rollup(A_{L-1}): the parent key folds the 4 children.
            rk = (prev_s << cb) | (prev_c >> 2)
            ruk, rinv = np.unique(rk, return_inverse=True)
            rv = (
                np.bincount(rinv, weights=prev_v)
                if len(rk) else np.empty(0, np.float64)
            )
            # Sum over non-all slots, keyed by the all-slot of their
            # timespan (slot = ts*G + g with g=0 the all group).
            um = ~all_mask
            if um.any():
                utk = (_all_slot_of(slots[um], is_all_slot) << cb) | codes[um]
                uuk, uinv = np.unique(utk, return_inverse=True)
                uv = np.bincount(uinv, weights=vals[um])
            else:
                uuk = np.empty(0, np.int64)
                uv = np.empty(0, np.float64)
            ak = (a_s << cb) | a_c
            new_all = (
                2.0 * _sorted_lookup(ruk, rv, ak)
                + _sorted_lookup(uuk, uv, ak)
            )
        if len(slots):
            patched = vals.copy()
            patched[all_mask] = new_all
            lvl["value"] = patched
        prev_s, prev_c, prev_v = a_s, a_c, new_all


def _all_slot_of(slots, is_all_slot):
    """Map each slot to the 'all' slot of its timespan block (the
    largest all-slot <= slot)."""
    all_ids = np.flatnonzero(is_all_slot)
    pos = np.searchsorted(all_ids, slots, side="right") - 1
    return all_ids[pos]
