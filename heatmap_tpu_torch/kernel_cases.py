"""Edge-case inputs of the segment-reduce, window-binning and projection
kernels.

Made with numpy from a seed, so the same inputs reach the card
(``chip_smoke.py`` holds each kernel bit-equal to its plain version on
them) and the CPU tests (``tests/test_torch_*.py`` hold the plain
versions equal to the JAX package on them). The shapes follow the
kernels' own geometry: segment runs and sentinel tails placed against
tile edges of ``ops.sparse_partitioned.TILE_KEYS`` keys, and cascade keys
of 61 and 62 bits (a dated z21 job's, and the widest the cascade packs);
points placed against the ragged sub-blocks of ``ops.partitioned.SUB_SIDE``
cells and split into work items of ``ops.partitioned.ITEM_POINTS``; and
windows of the histogram kernel at its bands' limits, with points where
the bands of ``ops.pallas_kernels.SLICE_BYTES`` meet; and points whose Mercator
rows sit on z21 row edges, at the world's edges and poles, non-finite,
on the antimeridian, and batches with ragged ends against the blocks of
the projection kernel.
"""

from __future__ import annotations

import math

import numpy as np

from heatmap_tpu_torch.ops.pallas_kernels import SLICE_BYTES
from heatmap_tpu_torch.ops.partitioned import ITEM_POINTS, SUB_SIDE
from heatmap_tpu_torch.ops.sparse_partitioned import TILE_KEYS

SENTINEL = np.iinfo(np.int64).max
#: Integer weights lie in [0, WEIGHT_BOUND].
WEIGHT_BOUND = 100

SEGMENT_CASES = (
    "run_over_tile",
    "run_over_three_tiles",
    "capacity_at_tile_edge",
    "sentinel_tail_mid_tile",
    "sentinel_tail_at_tile_edge",
    "below_one_tile",
    "one_key",
    "all_sentinel",
    "many_tiles",
    "keys_61_bits",
    "keys_62_bits",
)
#: The cascade's shifts are 2 * level: level 1, 5 and 15 (the last
#: level of the default z21 -> z6 job), beside 0.
SEGMENT_SHIFTS = (0, 2, 10, 30)


def _runs(rng, lengths):
    """Sorted keys below 2^50: one distinct key per run length."""
    lengths = np.asarray(lengths, np.int64)
    keys = np.sort(rng.choice(1 << 50, lengths.size, replace=False))
    return np.repeat(keys, lengths)


def _short_runs(rng, n):
    """Runs of 1 to 4 keys, ``n`` keys in all."""
    lengths = rng.integers(1, 5, n)
    lengths = lengths[: np.searchsorted(np.cumsum(lengths), n) + 1]
    lengths[-1] -= lengths.sum() - n
    return lengths[lengths > 0]


def _wide_runs(rng, n, key_bits):
    """``n`` sorted cascade keys of at most ``key_bits`` bits, in runs of
    1 to 4: slots above 42 bits of z21 Morton code, as
    ``pipeline.cascade.composite_keys`` packs them, four fifths of the
    slots with their top bit set. Keys come in fours that share their
    slot and the top 12 bits of their code, so the cascade's shifts
    merge them."""
    lengths = _short_runs(rng, n)
    groups = lengths.size // 4 + 1
    top = 1 << (key_bits - 43)
    slots = np.where(rng.random(groups) < 0.8,
                     rng.integers(top, 2 * top, groups),
                     rng.integers(0, top, groups))
    parents = (slots << 42) | (rng.integers(0, 1 << 12, groups) << 30)
    keys = np.unique(np.repeat(parents, 4)
                     | rng.integers(0, 1 << 30, 4 * groups))[:lengths.size]
    return np.repeat(keys, lengths[:keys.size])


def segment_case(name: str, tile: int = TILE_KEYS, seed: int = 0):
    """``(sorted int64 keys, capacity)`` of one named case; sentinel
    lanes hold int64 max."""
    rng = np.random.default_rng([seed, SEGMENT_CASES.index(name)])
    if name == "run_over_tile":
        # A run of 1.5 tiles that starts a third into tile 0.
        lengths = np.concatenate([_short_runs(rng, tile // 3),
                                  [tile + tile // 2],
                                  _short_runs(rng, tile)])
        keys = _runs(rng, lengths)
        return keys, keys.size
    if name == "run_over_three_tiles":
        # From the middle of tile 0, over all of tile 1, into tile 2.
        lengths = np.concatenate([_short_runs(rng, tile // 2),
                                  [2 * tile + 1],
                                  _short_runs(rng, tile // 2 + 7)])
        keys = _runs(rng, lengths)
        return keys, keys.size
    if name == "capacity_at_tile_edge":
        # A run ends exactly at the first tile edge, and capacity keeps
        # exactly the segments before it.
        head = _short_runs(rng, tile)
        keys = _runs(rng, np.concatenate([head, _short_runs(rng, tile + 9)]))
        return keys, head.size
    if name == "sentinel_tail_mid_tile":
        keys = _runs(rng, _short_runs(rng, tile + tile // 2 + 3))
        keys = np.concatenate([keys, np.full(tile + 11, SENTINEL)])
        return keys, keys.size
    if name == "sentinel_tail_at_tile_edge":
        keys = _runs(rng, _short_runs(rng, 2 * tile))
        keys = np.concatenate([keys, np.full(tile, SENTINEL)])
        return keys, keys.size
    if name == "below_one_tile":
        keys = _runs(rng, _short_runs(rng, tile // 4 + 1))
        return keys, keys.size
    if name == "one_key":
        return np.asarray([42], np.int64), 4
    if name == "all_sentinel":
        return np.full(tile + 5, SENTINEL, np.int64), 16
    if name == "many_tiles":
        # Geometric run lengths up to a few tiles, so the look-back
        # crosses many tiles that open no segment.
        lengths = np.minimum(rng.geometric(0.02, 24 * tile // 50),
                             3 * tile)
        keys = _runs(rng, lengths)[: 12 * tile + 5]
        return keys, len(np.unique(keys)) // 2
    if name == "keys_61_bits":
        # The widest keys of a dated z21 job (ROADMAP F9), ending with a
        # sentinel tail in the middle of a tile.
        keys = _wide_runs(rng, 2 * tile + tile // 2 + 3, 61)
        keys = np.concatenate([keys, np.full(tile + 11, SENTINEL)])
        return keys, keys.size
    if name == "keys_62_bits":
        # The widest keys composite_keys packs, the largest of them
        # (2^62 - 1) last before a sentinel tail that starts on a tile
        # edge.
        keys = _wide_runs(rng, 3 * tile - 3, 62)
        keys = np.concatenate([keys, np.full(3, (1 << 62) - 1),
                               np.full(tile, SENTINEL)])
        return keys, keys.size
    raise ValueError(f"unknown segment case {name!r}")


def segment_weights(keys, bound: int, seed: int = 0):
    """Integer float64 weights in [0, ``bound``], one per key."""
    rng = np.random.default_rng([seed, 99])
    return rng.integers(0, bound + 1, keys.size).astype(np.float64)


WINDOW_CASES = (
    "ragged",
    "ragged_thin",
    "sub_block_edges",
    "hot_sub_block",
    "all_outside",
    "uniform",
)


def window_case(name: str, seed: int = 0):
    """``(window fields, row int32, col int32, valid bool)`` of one named
    case; the fields are ``zoom, row0, col0, height, width``, for either
    package's ``Window``."""
    rng = np.random.default_rng([seed, WINDOW_CASES.index(name)])
    side = SUB_SIDE
    if name == "ragged_thin":
        # One row of the second sub-block row, and a ragged last column.
        fields = dict(zoom=13, row0=1000, col0=2000, height=side + 1,
                      width=4 * side + 37)
    else:
        # Sides that are not multiples of the sub-block side.
        fields = dict(zoom=12, row0=512, col0=256, height=2 * side + 44,
                      width=side + 72)
    h, w = fields["height"], fields["width"]
    r0, c0 = fields["row0"], fields["col0"]
    if name in ("ragged", "ragged_thin"):
        n = 20_000
        row = r0 + rng.integers(-20, h + 20, n)
        col = c0 + rng.integers(-20, w + 20, n)
    elif name == "sub_block_edges":
        # Every cell on a sub-block edge, the window's edges, and just
        # outside them.
        rr = np.unique(np.concatenate([np.arange(0, h, side),
                                       np.arange(side - 1, h, side),
                                       [-1, h - 1, h]]))
        cc = np.unique(np.concatenate([np.arange(0, w, side),
                                       np.arange(side - 1, w, side),
                                       [-1, w - 1, w]]))
        r, c = np.meshgrid(rr, cc, indexing="ij")
        row = np.repeat(r0 + r.ravel(), 3)
        col = np.repeat(c0 + c.ravel(), 3)
        n = row.size
    elif name == "hot_sub_block":
        # Two and a half work items of points in one ragged sub-block,
        # most of them on a few cells.
        n = 5 * ITEM_POINTS // 2
        row = r0 + 2 * side + rng.integers(0, h - 2 * side, n)
        col = c0 + side + rng.integers(0, w - side, n)
        row[: n // 2] = r0 + 2 * side + 3
        col[: n // 2] = c0 + side + rng.integers(0, 4, n // 2)
    elif name == "all_outside":
        n = 5000
        row = rng.integers(0, r0, n)
        col = c0 + rng.integers(0, w, n)
    elif name == "uniform":
        n = 30_000
        row = r0 + rng.integers(0, h, n)
        col = c0 + rng.integers(0, w, n)
    else:
        raise ValueError(f"unknown window case {name!r}")
    valid = rng.random(n) < 0.9
    return fields, row.astype(np.int32), col.astype(np.int32), valid


WEIGHT_KINDS = ("integer", "fractional", "nan_on_dropped")


def window_weights(kind: str, fields, row, col, valid, seed: int = 0):
    """float32 weights of one kind for a window case: integers in [0,
    WEIGHT_BOUND]; fractional values in [0, 10); or the integers with
    NaN on every dropped lane (outside the window, or invalid), which
    must never reach a raster."""
    # The NaN kind is the integer weights with its NaNs laid over them.
    rng = np.random.default_rng([seed, 7, int(kind == "fractional")])
    n = np.asarray(row).shape[0]
    if kind == "fractional":
        return (rng.random(n) * 10.0).astype(np.float32)
    w = rng.integers(0, WEIGHT_BOUND + 1, n).astype(np.float32)
    if kind == "nan_on_dropped":
        r = np.asarray(row, np.int64) - fields["row0"]
        c = np.asarray(col, np.int64) - fields["col0"]
        ok = ((r >= 0) & (r < fields["height"]) & (c >= 0)
              & (c < fields["width"]) & np.asarray(valid, bool))
        w[~ok] = np.nan
    elif kind != "integer":
        raise ValueError(f"unknown weight kind {kind!r}")
    return w


HISTOGRAM_CASES = (
    "square_256",
    "ragged_255x257",
    "one_row",
    "slice_edges",
    "hot_cell",
)
#: Cells of one band of the histogram's window.
SLICE_CELLS = SLICE_BYTES // 4
HOT_CELL_COUNT = (1 << 16) + 1000


def histogram_case(name: str, seed: int = 0):
    """``(window fields, row int32, col int32, valid bool)`` of one named
    case of the window-histogram kernel: exactly 256x256 cells (two full
    bands), 255x257 (65,535 cells, ragged, bands meeting mid-row), one
    row, points on the cells where bands of SLICE_CELLS (and of half
    that) meet, and one cell hit past 2^16 times."""
    rng = np.random.default_rng([seed, 100 + HISTOGRAM_CASES.index(name)])
    if name in ("ragged_255x257", "slice_edges"):
        fields = dict(zoom=14, row0=3000, col0=5000, height=255, width=257)
    elif name == "one_row":
        fields = dict(zoom=13, row0=77, col0=1000, height=1, width=300)
    elif name == "hot_cell":
        fields = dict(zoom=12, row0=900, col0=1800, height=64, width=64)
    else:
        fields = dict(zoom=14, row0=3000, col0=5000, height=256, width=256)
    h, w = fields["height"], fields["width"]
    r0, c0 = fields["row0"], fields["col0"]
    if name == "slice_edges":
        # Every cell of the rows where bands meet, and the cells just
        # before and after each meeting point, three times each.
        meet = [k * s for s in (SLICE_CELLS // 2, SLICE_CELLS)
                for k in range(1, h * w // s + 1) if k * s < h * w]
        rows = sorted({m // w for m in meet} | {(m - 1) // w for m in meet})
        flat = np.concatenate([np.arange(r * w, (r + 1) * w) for r in rows]
                              + [np.asarray(meet) + d for d in (-2, -1, 0, 1)])
        flat = np.repeat(flat, 3)
        row, col = r0 + flat // w, c0 + flat % w
    elif name == "hot_cell":
        n = HOT_CELL_COUNT + 3000
        row = r0 + rng.integers(-4, h + 4, n)
        col = c0 + rng.integers(-4, w + 4, n)
        row[:HOT_CELL_COUNT] = r0 + 17
        col[:HOT_CELL_COUNT] = c0 + 40
    else:
        n = 12_000
        row = r0 + rng.integers(-10, h + 10, n)
        col = c0 + rng.integers(-10, w + 10, n)
    n = row.size
    valid = rng.random(n) < 0.9
    if name == "hot_cell":
        valid[:HOT_CELL_COUNT] = True
    return fields, row.astype(np.int32), col.astype(np.int32), valid


PROJECTION_CASES = (
    "row_edges_z21",
    "mercator_edge",
    "beyond_poles",
    "non_finite",
    "antimeridian",
    "geolife_z16",
    "geolife_z21",
    "empty",
    "one",
    "below_one_block",
    "ragged",
)
#: Lanes that one block of ``csrc/project_mercator.cu`` takes (256
#: threads of 4 lanes).
PROJECT_BLOCK_LANES = 1024
#: Latitude of the square Web-Mercator world's edge, atan(sinh(pi)).
_MAX_LATITUDE = math.degrees(math.atan(math.sinh(math.pi)))


def row_edge_latitudes(seed: int = 1):
    """700,000 float64 latitudes: 100,000 z21 row edges and the three
    doubles on either side of each."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 21, 100_000)
    n = math.pi - 2.0 * math.pi * rows / float(1 << 21)
    edge = 180.0 / math.pi * np.arctan(0.5 * (np.exp(n) - np.exp(-n)))
    near = [edge]
    up = down = edge
    for _ in range(3):
        up = np.nextafter(up, np.inf)
        down = np.nextafter(down, -np.inf)
        near += [up, down]
    return np.concatenate(near)


def _ulps(x: float, k: int):
    """``x`` and the ``k`` doubles on either side of it."""
    out = [x]
    up = down = x
    for _ in range(k):
        up = np.nextafter(up, np.inf)
        down = np.nextafter(down, -np.inf)
        out += [up, down]
    return np.array(out)


def _city_points(n: int, rng):
    """``n`` float64 points in the manner of GeoLife's traces: three in
    four spread over a city (Beijing), one in four in a hot spot at its
    center. A plain seeded mixture; the benchmark's own points come from
    ``benchmark/generate.py``."""
    n_hot = n // 4
    cols = []
    for c, wide, hot in ((39.9, 0.12, 0.01), (116.4, 0.16, 0.015)):
        cols.append(np.concatenate([rng.normal(c, wide, n - n_hot),
                                    rng.normal(c, hot, n_hot)]))
    return cols[0], cols[1]


def projection_case(name: str, seed: int = 0):
    """``(lat float64, lon float64, zoom)`` of one named case."""
    rng = np.random.default_rng([seed, 200 + PROJECTION_CASES.index(name)])
    if name == "row_edges_z21":
        # Every lane lies within a few ulps of a row edge: all flagged,
        # far more than the kernel's first list holds.
        lat = row_edge_latitudes()
        return lat, np.linspace(-179.0, 179.0, lat.size), 21
    if name == "mercator_edge":
        # The world's edge: rows 0 and -1 (and 2^zoom - 1 and 2^zoom)
        # meet there.
        edges = np.concatenate([
            _ulps(s * x, 3) for s in (1.0, -1.0)
            for x in (_MAX_LATITUDE, 85.0511, 85.06, 85.05)])
        lat = np.concatenate([np.repeat(edges, 40),
                              rng.uniform(-85.06, -85.04, 500),
                              rng.uniform(85.04, 85.06, 500)])
        return lat, rng.uniform(-180.0, 180.0, lat.size), 21
    if name == "beyond_poles":
        # |lat| >= 90: no pole clamping, so some rows come out valid.
        far = np.array([90.0, 90.5, 95.0, 135.0, 180.0, 270.0, 360.0,
                        720.0, 1e4])
        lat = np.concatenate([np.repeat(np.concatenate(
            [_ulps(90.0, 2), far, -far]), 30),
            rng.uniform(90.0, 400.0, 500), rng.uniform(-400.0, -90.0, 500)])
        return lat, rng.uniform(-180.0, 180.0, lat.size), 16
    if name == "non_finite":
        bad = np.array([np.nan, np.inf, -np.inf, 40.0])
        lat, lon = np.meshgrid(bad, np.array([np.nan, np.inf, -np.inf,
                                              116.0]))
        lat = np.repeat(lat.ravel(), 70)
        lon = np.repeat(lon.ravel(), 70)
        mixed = rng.random(lat.size) < 0.5
        lat[mixed] = rng.uniform(-80.0, 80.0, int(mixed.sum()))
        return lat, lon, 10
    if name == "antimeridian":
        # lon == 180 gives column 2^zoom (invalid); -180 gives column 0.
        edges = np.concatenate([_ulps(180.0, 2), _ulps(-180.0, 2),
                                [179.9999999, -179.9999999, 0.0, -0.0,
                                 200.0, -200.0]])
        lon = np.concatenate([np.repeat(edges, 50),
                              rng.uniform(179.99, 180.01, 500)])
        return rng.uniform(-80.0, 80.0, lon.size), lon, 21
    if name in ("geolife_z16", "geolife_z21"):
        lat, lon = _city_points(200_000, rng)
        return lat, lon, int(name[-2:])
    if name == "empty":
        return np.zeros(0), np.zeros(0), 16
    if name == "one":
        return np.array([51.5074]), np.array([-0.1278]), 10
    if name in ("below_one_block", "ragged"):
        # Not a multiple of the block's lanes, nor of a thread's 4.
        n = (PROJECT_BLOCK_LANES - 3 if name == "below_one_block"
             else 3 * PROJECT_BLOCK_LANES + 5)
        return (rng.uniform(-85.0, 85.0, n), rng.uniform(-180.0, 180.0, n),
                12)
    raise ValueError(f"unknown projection case {name!r}")
